"""frames_per_call frames a call through the port's match_many (one
batch, the frame axis through every stage): consecutive frames of the
pool, uploaded together from the host."""


def prepare(ctx):
    per, n = ctx.traffic["frames_per_call"], len(ctx.pool)
    if n % per:
        raise ValueError(f"a pool of {n} frames does not split into calls "
                         f"of {per}")

    def call(k):
        lo = (k * per) % n
        out = ctx.fipm.match_many(ctx.pool[lo:lo + per],
                                  ctx.learned.pattern, ctx.learned.cfg,
                                  device=ctx.device)
        return [(lo + j, ctx.rows(r)) for j, r in enumerate(out)]
    return call
