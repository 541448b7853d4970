"""Hand-written CUDA kernels, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (never the calls served by the plain version on CPU tensors), so a
run can show that its main path went through the kernels.  A wrapper with
more than one kernel (one per input type) also counts each launch under
``ROUTE_LAUNCHES["<wrapper>:<route>"]``: ``tensor_core`` for the bf16 and
int8 kernels on ``mma.sync``, ``cuda_core`` for the f32 kernels; for the ADC
kernels ``vector`` (8- or 4-byte code loads) or ``byte`` (one code
byte a load, for a row length or codes address the vector loads cannot
take).
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"fused_topk": 0, "encoder_attention": 0,
                             "adc_scores": 0, "adc_scores_lut16": 0,
                             "bm25_scatter": 0}
ROUTE_LAUNCHES: dict[str, int] = {
    "fused_topk:tensor_core": 0, "fused_topk:cuda_core": 0,
    "encoder_attention:tensor_core": 0, "encoder_attention:cuda_core": 0,
    "adc_scores:vector": 0, "adc_scores:byte": 0,
    "adc_scores_lut16:vector": 0, "adc_scores_lut16:byte": 0}


def count_launch(name: str, route: str | None = None) -> None:
    LAUNCHES[name] += 1
    if route is not None:
        ROUTE_LAUNCHES[f"{name}:{route}"] += 1


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0
