"""One frame a call through the port's orb_match: the pool's frames in
turn, each a host u8 array that the call uploads, against the host u8
template, whose features the call detects again (as the reference
tool's performORBMatching does)."""


def prepare(ctx):
    pool, n = ctx.pool, len(ctx.pool)

    def call(k):
        i = k % n
        res = ctx.fipm.orb_match(pool[i], ctx.learned.template,
                                 ctx.learned.cfg,
                                 seed=ctx.learned.seed, device=ctx.device)
        return [(i, ctx.rows(res))]
    return call
