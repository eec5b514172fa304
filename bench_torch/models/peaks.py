"""Published peaks of the cards the benchmark knows, the denominators of
every roofline and MFU share it reports.

NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates at the full
700 W: 67 TFLOP/s in float32 outside the tensor cores (the rate of the
configurations' float32 with TF32 off) and 3.35 TB/s of HBM3.  A card set
below 700 W runs slower under load; the result's ``card`` gives its limit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peak(NamedTuple):
    fp32_flops: float  # per second, outside the tensor cores
    hbm_bytes: float   # per second


H100_SXM = Peak(67e12, 3.35e12)
# matched in order on the lower-cased torch.cuda.get_device_name()
PEAKS = (("h100 80gb hbm3", H100_SXM), ("h100 sxm", H100_SXM))


def peak_of(device_name: str) -> Optional[Peak]:
    name = device_name.lower()
    return next((p for key, p in PEAKS if key in name), None)


def roofline_s(n_bytes: float, fp32_ops: float, peak: Peak) -> float:
    """The least time the card could take for work that moves ``n_bytes``
    and does ``fp32_ops`` float32 operations: the larger of the two."""
    return max(n_bytes / peak.hbm_bytes, fp32_ops / peak.fp32_flops)
