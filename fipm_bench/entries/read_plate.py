"""One plate a call through the port's glyph read, the CLI's `ocr
--cross-nms` path: MultiTemplateMatcher.match_all (match_patterns over
the learned glyph set, then the suppression across glyphs when the
configuration asks for it) and read_string at the configuration's score.
The pool's plates in turn, each a host u8 array that the call uploads."""


def prepare(ctx):
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import read_string
    pool, n, lr = ctx.pool, len(ctx.pool), ctx.learned

    def call(k):
        i = k % n
        matches = lr.matcher.match_all(pool[i], cross_nms=lr.cross_nms)
        text = read_string(matches, lr.cfg.score)
        return [(i, ctx.rows((matches, text, lr.labels)))]
    return call
