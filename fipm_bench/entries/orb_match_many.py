"""frames_per_call frames a call through the port's orb_match_many (one
batch against the host u8 template, whose features the call detects
again): consecutive frames of the pool, host u8 arrays that the call
uploads, one answer each."""


def prepare(ctx):
    per, n = ctx.traffic["frames_per_call"], len(ctx.pool)
    if n % per:
        raise ValueError(f"a pool of {n} frames does not split into calls "
                         f"of {per}")

    def call(k):
        lo = (k * per) % n
        out = ctx.fipm.orb_match_many(ctx.pool[lo:lo + per],
                                      ctx.learned.template, ctx.learned.cfg,
                                      seed=ctx.learned.seed,
                                      device=ctx.device)
        return [(lo + j, ctx.rows(r)) for j, r in enumerate(out)]
    return call
