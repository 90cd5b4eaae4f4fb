"""VectorCodec — row storage for the index (fp32 in this slice).

The reference (``repro/core/codec.py``) owns three codecs: ``fp32``
(identity), ``bf16`` and ``int8`` (one fp32 scale per row). This slice of
the port serves ``fp32`` only; the lossy codecs and their fused decode in
the kernels are queued (ROADMAP.md §1, "bf16/int8 variants of the three
kernels plus codec.py") and raise ``NotImplementedError`` by name.
Nothing here assumes ``ml_dtypes``: the bf16 codec, when ported, uses
torch's own ``bfloat16``.
"""
from __future__ import annotations

import numpy as np

CODEC_NAMES = ("fp32", "bf16", "int8")


class VectorCodec:
    """One row-storage format: encode/decode + storage dtype.

    ``name``            factory name
    ``lossy``           False only for fp32 — lossless codecs keep no
                        encoded side arrays
    ``uses_scales``     True when rows carry a per-row fp32 scale
    ``enc_dtype``       numpy dtype of the encoded array
    ``default_rerank``  over-fetch factor for ANN search
    """

    name: str = "fp32"
    lossy: bool = False
    uses_scales: bool = False
    default_rerank: int = 1
    enc_dtype = np.dtype(np.float32)

    def encode(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
        """fp32 rows [..., D] -> (encoded rows, per-row scales or None)."""
        return np.ascontiguousarray(x, np.float32), None

    def decode(self, enc: np.ndarray,
               scales: np.ndarray | None = None) -> np.ndarray:
        """Inverse of :meth:`encode` -> fp32 rows."""
        return np.asarray(enc, np.float32)


_FP32 = VectorCodec()


def get_codec(name: str) -> VectorCodec:
    """Codec by name. Only "fp32" is ported in this slice."""
    key = str(name).lower()
    if key not in CODEC_NAMES:
        raise ValueError(f"unknown storage dtype {name!r}; expected one of "
                         f"{CODEC_NAMES}")
    if key != "fp32":
        raise NotImplementedError(
            f"storage dtype {key!r} is not ported yet (ROADMAP.md §1: "
            "bf16/int8 variants of the kernels plus codec.py)")
    return _FP32

