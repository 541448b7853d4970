"""Hand-written CUDA kernels, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (never the calls served by the plain version on CPU tensors), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"fused_topk": 0, "encoder_attention": 0,
                             "adc_scores": 0, "adc_scores_lut16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
