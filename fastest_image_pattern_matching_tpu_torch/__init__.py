"""fastest_image_pattern_matching_tpu_torch — the PyTorch / CUDA port of
fastest_image_pattern_matching_tpu for an NVIDIA H100.

Rotation-invariant template matching: image-pyramid coarse-to-fine
normalised cross-correlation with rotation search, subpixel (x, y, theta)
refinement, greedy multi-target peak extraction and rotated-rect NMS. The
public functions take an explicit `device` (CUDA by default). On a CUDA
device every warp runs the hand-written kernel in csrc/warp_affine.cu and
every large-map correlation (tol=0 many-target scenes, match_template) the
one in csrc/ccorr_valid.cu. Batches of frames (match_many, BatchMatcher,
inspect_corpus) run through the same pipeline with frames as its leading
axis; glyph sets through match_patterns and MultiTemplateMatcher. ORB
feature matching (orb_match, orb_match_many) is the secondary path, and
`python -m fastest_image_pattern_matching_tpu_torch.cli` the command line.
Several processes (one per GPU, torch.distributed) share a batch through
init_distributed, make_mesh and match_batch_sharded, and the serving paths
through make_data_mesh, orb_match_many_sharded and match_patterns_sharded.
Deployment packs (export_match_pack / AotMatcher, export_orb_pack /
AotOrb) freeze one (pattern, config, frame shape, batch buckets) into a
file that a fresh process loads and matches with, the kernels' libraries
bundled.

The pyramid and the top-layer correlation are exact in f32 only without
TF32, so importing the package turns TF32 off for matmuls and cuDNN.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import MatchConfig
from .types import LearnedPattern, MatchResult
from .models.template_matcher import (TemplateMatcher, learn_pattern, match,
                                      match_arrays, match_candidates,
                                      match_template, pattern_from_reference)
from .models.batch import (BatchMatcher, match_many, match_many_arrays,
                           match_patterns)
from .models.multi_template import MultiTemplateMatcher
from .models.corpus import inspect_corpus
from .models.orb import ORBConfig, ORBResult, orb_match, orb_match_many
from .parallel.matcher import match_batch_sharded
from .parallel.mesh import init_distributed, make_mesh
from .parallel.serving import (make_data_mesh, match_patterns_sharded,
                               orb_match_many_sharded)
from .aot import AotMatcher, AotOrb, export_match_pack, export_orb_pack

__all__ = [
    "MatchConfig", "LearnedPattern", "MatchResult", "TemplateMatcher",
    "learn_pattern", "match", "match_arrays", "match_candidates",
    "match_template", "pattern_from_reference", "BatchMatcher",
    "match_many", "match_many_arrays", "match_patterns",
    "MultiTemplateMatcher", "inspect_corpus", "ORBConfig", "ORBResult",
    "orb_match", "orb_match_many", "match_batch_sharded", "make_mesh",
    "init_distributed", "orb_match_many_sharded", "match_patterns_sharded",
    "make_data_mesh", "AotMatcher", "AotOrb", "export_match_pack",
    "export_orb_pack",
]
