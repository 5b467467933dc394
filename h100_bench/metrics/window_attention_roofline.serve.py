"""The window attention's share of its roofline in the traced stretch of a
serving window, in percent: the summed bound of every call the program's
``window_attention`` counter saw (ops/window_attention.py, counted only
while the profiler runs; h100_bench/roofline_window_attention.py) over the
device time of the attention kernels by name (ATTENTION: the kernel
``F.scaled_dot_product_attention`` ran on the H100 in bfloat16 with PyTorch
2.11, cuDNN's ``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_*``,
and PyTorch's own fused kernels, ``fmha_cutlass*`` and ``flash_fwd*``, should
it choose them). None where the program keeps no such counter or no such
kernel ran."""
import re

from h100_bench.roofline_window_attention import attention_bound_s, windows_per_volume
from h100_bench.trace import device_seconds

ATTENTION = re.compile(r"fmha_cutlass|flash_fwd|flash::|cudnn_generated_fort_native_sdpa|"
                       r"attention_kernel|fmha_", re.IGNORECASE)


def read(ctx):
    try:
        from segmentation_pipeline_torch.utils.timer import recorded
    except ImportError:
        return None
    calls = recorded()["counters"].get("window_attention")
    seconds = device_seconds(ctx["summary"], ATTENTION)
    if not calls or seconds <= 0:
        return None
    cfg, patch = ctx["config"], ctx["traffic"]["patch"]
    bound = 0.0
    for key, n in calls.items():
        nw = windows_per_volume((patch,) * 3, cfg["patch_size"], cfg["window_size"], key[0])
        bound += n * attention_bound_s(key, nw)
    return 100.0 * bound / seconds
