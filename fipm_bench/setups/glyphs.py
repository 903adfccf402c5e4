"""Set-up of an OCR configuration: the port's MatchConfig from the
configuration's `match` fields and a MultiTemplateMatcher that learns
the scene's glyph set, in the set's order; an answer is one plate's read
as the comparison takes it."""

import types

import numpy as np


def learn(fipm, config: dict, glyphs: dict, device):
    """-> what the entries get as ctx.learned: .matcher, .cfg,
    .cross_nms (the configuration's) and .labels (the glyph set's
    labels, in order)."""
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import MultiTemplateMatcher
    cfg = fipm.MatchConfig(**config["match"])
    m = MultiTemplateMatcher(cfg, device=device)
    for label, g in glyphs.items():
        m.learn(label, g)
    return types.SimpleNamespace(matcher=m, cfg=cfg,
                                 cross_nms=config["cross_nms"],
                                 labels=list(glyphs))


def rows(read) -> dict:
    """read: (the labelled matches of one plate, its string, the glyph
    set's labels) -> {"text": the string, "rows": [n, 5] f64 rows of
    (label index in the set, score, angle deg, centre x, centre y), in
    the matches' order}."""
    matches, text, labels = read
    index = {label: i for i, label in enumerate(labels)}
    out = [[index[m.label], m.result.score, m.result.angle,
            m.result.center[0], m.result.center[1]] for m in matches]
    return {"text": text, "rows": np.array(out, np.float64).reshape(-1, 5)}
