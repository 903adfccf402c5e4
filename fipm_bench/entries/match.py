"""One frame a call through the port's match(): the pool's frames in
turn, each a host u8 array that the call uploads."""


def prepare(ctx):
    pool, n = ctx.pool, len(ctx.pool)

    def call(k):
        i = k % n
        res = ctx.fipm.match(pool[i], ctx.learned.pattern,
                             ctx.learned.cfg, device=ctx.device)
        return [(i, ctx.rows(res))]
    return call
