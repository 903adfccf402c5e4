"""The port's entries of template matching share one input step
(models/template_matcher.py::_frames) and each keeps the size guards of
its JAX twin: match, match_many, match_patterns, AotMatcher.match and
match_batch_sharded (at world 1 on gloo) refuse the same bad inputs with
the same errors. Imports no JAX."""

import datetime
import socket

import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu_torch as tfipm

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower.
torch.set_num_threads(1)

FRAME_HW = (90, 100)
CFG = tfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=30.0)

# Each bad input: a frame with values above 255, one smaller than the
# 24x32 template in both sides, and one of Match()'s unsupported size
# relations (shorter but wider than the template).
BAD = {"u8": np.full(FRAME_HW, 300.0), "larger": np.zeros((20, 30)),
       "relation": np.zeros((20, 200))}
ERROR = {"u8": "8-bit contract", "larger": "template larger than source",
         "relation": "size relation unsupported"}

# The bad inputs each entry refuses: match_many checks the area alone (as
# the JAX package's batch does), match_patterns the values alone, and a
# pack every frame of another shape than its own.
REFUSES = {"match": ("u8", "larger", "relation"),
           "match_many": ("u8", "larger"),
           "match_patterns": ("u8",),
           "aot": ("u8", "larger", "relation"),
           "sharded": ("u8", "larger", "relation")}


@pytest.fixture(scope="module")
def pattern():
    tpl = np.random.default_rng(5).integers(0, 255, (24, 32), np.uint8)
    return tfipm.learn_pattern(tpl, CFG.min_reduce_area, device="cpu")


@pytest.fixture(scope="module")
def pack(pattern, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("front_door") / "p.npz")
    tfipm.export_match_pack(path, pattern, CFG, FRAME_HW, device="cpu")
    return tfipm.AotMatcher.load(path, device="cpu")


@pytest.fixture(scope="module")
def gloo_mesh():
    """A world of one gloo rank in this process, left when the module's
    tests are done."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tfipm.init_distributed("gloo", f"tcp://127.0.0.1:{port}", 1, 0,
                           timeout=datetime.timedelta(seconds=60))
    try:
        yield tfipm.make_mesh((1, 1), device="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("entry,bad", [(e, b) for e, bads in REFUSES.items()
                                       for b in bads])
def test_entries_refuse_bad_inputs_alike(request, pattern, entry, bad):
    src = BAD[bad]
    error = ERROR[bad]
    if entry == "match":
        call = lambda: tfipm.match(src, pattern, CFG, device="cpu")
    elif entry == "match_many":
        call = lambda: tfipm.match_many(src[None], pattern, CFG,
                                        device="cpu")
    elif entry == "match_patterns":
        call = lambda: tfipm.match_patterns(src, [pattern], CFG,
                                            device="cpu")
    elif entry == "aot":
        m = request.getfixturevalue("pack")
        call = lambda: m.match(src)
        if bad != "u8":
            error = "pack serves frames of shape"
    else:
        mesh = request.getfixturevalue("gloo_mesh")
        assert mesh.groups != (None, None)
        call = lambda: tfipm.match_batch_sharded(src[None], pattern, CFG,
                                                 mesh)
    with pytest.raises(ValueError, match=error):
        call()
