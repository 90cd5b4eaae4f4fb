"""VectorCodec — row storage for the index, ported from
``repro/core/codec.py`` (numpy in both packages, so bit-identical).

  * ``fp32``  — identity.
  * ``bf16``  — the top 16 bits of each fp32, rounded to nearest even;
    2 bytes/dim, no side table.
  * ``int8``  — scalar quantization with ONE fp32 scale per row
    (``scale = max|x| / 127``, symmetric): 1 byte/dim + 4 bytes/row.

Quantize-at-ingest: a lossy index encodes each row once, after any metric
normalization, and keeps the encoded rows (what the device holds) beside
their fp32 decode (what the exact rerank reads). ANN search under a lossy
codec over-fetches ``k · rerank_factor`` candidates and re-scores them
exactly in fp32 (:func:`rerank_exact`).

The bf16 codec needs no ``ml_dtypes``: it encodes with the uint32 bit
trick, which rounds exactly as ``ml_dtypes`` does (NaN becomes the quiet
NaN ``0x7fc0`` with its sign), and holds the encoded rows on the host as
their uint16 bits — the reference's ``to_storage`` form. On the device
they are a ``torch.bfloat16`` tensor (:func:`device_rows`).
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.float32(3e38)

CODEC_NAMES = ("fp32", "bf16", "int8")


class VectorCodec:
    """One row-storage format: encode/decode + storage dtype.

    ``name``            factory name ("fp32" | "bf16" | "int8")
    ``lossy``           False only for fp32 — lossless codecs keep no
                        encoded side arrays
    ``uses_scales``     True when rows carry a per-row fp32 scale
    ``enc_dtype``       numpy dtype of the encoded array
    ``default_rerank``  over-fetch factor for ANN search (k·factor
                        candidates, exact fp32 rerank)
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

    def roundtrip(self, x: np.ndarray) -> np.ndarray:
        return self.decode(*self.encode(x))

    # Snapshot pages / npz exports hold builtin numpy dtypes only.
    def to_storage(self, enc: np.ndarray) -> np.ndarray:
        return enc

    def from_storage(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr, self.enc_dtype)

    def bytes_per_vector(self, dim: int) -> int:
        """Encoded bytes per row (scale included when the codec has one)."""
        return dim * self.enc_dtype.itemsize + (4 if self.uses_scales else 0)


class Bf16Codec(VectorCodec):
    """bf16 rows, held as their uint16 bits."""

    name = "bf16"
    lossy = True
    uses_scales = False
    default_rerank = 1
    enc_dtype = np.dtype(np.uint16)

    def encode(self, x):
        u = np.ascontiguousarray(x, np.float32).view(np.uint32)
        bits = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
                >> 16).astype(np.uint16)
        nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
        if nan.any():
            bits[nan] = ((u[nan] >> 16) & np.uint32(0x8000)
                         | np.uint32(0x7FC0)).astype(np.uint16)
        return bits, None

    def decode(self, enc, scales=None):
        return (np.asarray(enc, np.uint16).astype(np.uint32)
                << 16).view(np.float32)

    def to_storage(self, enc):
        return np.asarray(enc, np.uint16)

    def from_storage(self, arr):
        return np.asarray(arr, np.uint16)


class Int8Codec(VectorCodec):
    """Symmetric scalar quantization, one fp32 scale per row:
    ``scale = max|x| / 127``, ``enc = round(x / scale)`` in [-127, 127].
    All-zero rows get scale 1.0 so decode stays a plain multiply."""

    name = "int8"
    lossy = True
    uses_scales = True
    default_rerank = 4
    enc_dtype = np.dtype(np.int8)

    def encode(self, x):
        x = np.ascontiguousarray(x, np.float32)
        amax = np.max(np.abs(x), axis=-1)
        scales = np.where(amax > 0, amax / np.float32(127.0),
                          np.float32(1.0)).astype(np.float32)
        q = np.clip(np.rint(x / scales[..., None]), -127, 127)
        return q.astype(np.int8), scales

    def decode(self, enc, scales=None):
        if scales is None:
            raise ValueError("int8 decode needs the per-row scales")
        return (np.asarray(enc, np.float32)
                * np.asarray(scales, np.float32)[..., None])


_CODECS: dict[str, VectorCodec] = {}


def get_codec(name: str) -> VectorCodec:
    """Codec by name ("fp32" | "bf16" | "int8"); instances are shared."""
    key = str(name).lower()
    if key not in CODEC_NAMES:
        raise ValueError(f"unknown storage dtype {name!r}; expected one of "
                         f"{CODEC_NAMES}")
    if key not in _CODECS:
        _CODECS[key] = {"fp32": VectorCodec, "bf16": Bf16Codec,
                        "int8": Int8Codec}[key]()
    return _CODECS[key]


def device_rows(enc: np.ndarray, device) -> torch.Tensor:
    """Encoded host rows -> the tensor the kernels read on ``device``:
    uint16 bf16 bits become ``torch.bfloat16``, fp32 and int8 keep their
    dtype."""
    enc = np.ascontiguousarray(enc)
    if enc.dtype == np.uint16:
        return torch.from_numpy(enc.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(enc).to(device)


def effective_rerank(codec: VectorCodec, rerank_factor: int | None) -> int:
    """The over-fetch factor a backend should use: the configured value,
    else the codec default. Lossless codecs never rerank (factor 1) —
    the first pass already IS the exact fp32 search."""
    if not codec.lossy:
        return 1
    rf = rerank_factor if rerank_factor is not None else codec.default_rerank
    return max(int(rf), 1)


def check_codec_arrays(codec: VectorCodec, arrays: dict, kind: str) -> None:
    """Cross-dtype restore guard: encoded pages cannot be transcoded, so an
    index restoring state written under a different storage dtype must
    fail loudly and helpfully, not with a KeyError."""
    has_enc = any(name.split("__")[-1] == "vectors_enc" for name in arrays)
    if codec.lossy and not has_enc and arrays:
        raise ValueError(
            f"cannot restore a {kind!r} index as dtype={codec.name!r}: the "
            "stored state holds fp32 rows. Storage dtype is part of the "
            "stored bytes — restore with dtype='fp32', or re-ingest the "
            f"corpus into a fresh {codec.name} store.")
    if not codec.lossy and has_enc:
        raise ValueError(
            f"cannot restore a {kind!r} index as dtype='fp32': the stored "
            "state holds codec-encoded rows (bf16/int8 pages cannot be "
            "transcoded back). Restore with the dtype the store records "
            "in config.json, or re-ingest into a fresh fp32 store.")


def rerank_exact(vectors: np.ndarray, queries: np.ndarray, ids: np.ndarray,
                 k: int, *, metric: str) -> tuple[np.ndarray, np.ndarray]:
    """Exact fp32 re-scoring of over-fetched ANN candidates.

    vectors [N, D] — the canonical host rows, fp32, already metric-
    normalized where the backend stores them normalized (cosine);
    queries [B, D] raw (normalized here for cosine); ids [B, KK] with -1
    marking missing candidates -> (dists [B, k], ids [B, k]), missing
    slots (INF, -1). Ties break on the smaller id.
    """
    q = np.asarray(queries, np.float32)
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    b = q.shape[0]
    out_d = np.full((b, k), INF, np.float32)
    out_i = np.full((b, k), -1, np.int64)
    ids = np.asarray(ids)
    for row in range(b):
        cand = np.unique(ids[row][ids[row] >= 0]).astype(np.int64)
        if cand.size == 0:
            continue
        x = np.asarray(vectors, np.float32)[cand]
        if metric in ("cosine", "ip"):
            d = np.float32(1.0) - x @ q[row]
        else:
            diff = x - q[row][None, :]
            d = np.einsum("kd,kd->k", diff, diff)
        d = d.astype(np.float32)
        order = np.lexsort((cand, d))[:k]
        out_d[row, : order.size] = d[order]
        out_i[row, : order.size] = cand[order]
    return out_d, out_i
