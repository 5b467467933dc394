"""Device milliseconds per served subject of the normalization kernels in
the traced stretch: the InstanceNorms (models/components.py: the Welford
statistics and the fused normalize, ``addcmul``) and the LayerNorms
(models/swin_unetr.py: the blocks', PatchMerging's and ``proj_out``'s), by
kernel name (NORMS). The float32 copy an InstanceNorm of a bfloat16 tensor
takes its statistics from runs as ATen's copy kernel, shared with every
other cast, and is not counted. None where no such kernel ran."""
import re

from h100_bench.trace import device_seconds

NORMS = re.compile(r"WelfordOps|layer_norm|LayerNorm|addcmul", re.IGNORECASE)


def read(ctx):
    seconds = device_seconds(ctx["summary"], NORMS)
    subjects = ctx["work"].get("subjects")
    if not seconds or not subjects:
        return None
    return 1e3 * seconds / subjects
