"""Product quantization (PQ): the codec, ADC top-k and a flat PQ index.

Counterpart of ``archi_tpu/engine/pq.py``.  A row is stored as ``m`` uint8
codes, one per subspace of ``ds = D / m`` dims; a query's score against it
is the sum of ``m`` entries of its lookup table (``q_sub · centroid``),
scored by the ADC kernels of ``archi_tpu_torch.ops.adc``.

- **Training** (``PQCodec.train``): all ``m`` subspace k-means run at once
  as one batched matmul + ``index_add_`` per iteration; optional OPQ
  rotation by alternating short PQ trainings with a Procrustes update.
- **Encoding**: blocked argmin of ``||c||^2 - 2 x·c`` over the same batched
  matmul, chunked so the [m, chunk, ksub] distances stay ~0.4 GB.
- **ADC search** (``adc_topk``): ``impl="kernel"`` scores with the CUDA
  kernel (its plain version on CPU tensors), ``"plain"`` with the plain
  version on any device; ``"auto"`` is ``"kernel"``.

Random draws use ``np.random.default_rng(seed)`` in the JAX package's
order, so both packages train from the same rows.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from archi_tpu_torch.engine.flat_index import (jsonable_ids, l2_normalize,
                                               load_npz)
from archi_tpu_torch.engine.topk import NEG_INF, topk_lower_first
from archi_tpu_torch.ops.adc import adc_scores, plain_adc_scores
from archi_tpu_torch.utils.hardware import default_device


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor as it is, or a host array moved to ``device`` (default
    cuda)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not arr.flags.writeable:   # torch wants to own writable memory
        arr = arr.copy()
    return torch.as_tensor(arr, device=default_device(device))


# --------------------------------------------------------------------- train

def _pq_assign(xs, codebooks, *, chunk: int = 1 << 13):
    """xs [m, n, ds], codebooks [m, ksub, ds] → codes [m, n] int64: the L2
    argmin per subspace (``||c||^2 - 2 x·c``), first index on ties."""
    cb = codebooks.float()
    c2 = torch.sum(cb * cb, dim=-1)                        # [m, ksub]
    parts = []
    for s in range(0, xs.shape[1], chunk):
        xc = torch.bmm(xs[:, s:s + chunk].float(), cb.transpose(1, 2))
        parts.append(torch.argmin(c2[:, None, :] - 2.0 * xc, dim=-1))
    if not parts:
        return torch.zeros((xs.shape[0], 0), dtype=torch.long,
                           device=xs.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _pq_update_stats(xs, codes, ksub: int):
    """→ (sums [m, ksub, ds], counts [m, ksub]) for one training batch."""
    m, n, ds = xs.shape
    seg = (codes + ksub * torch.arange(m, device=xs.device)[:, None]).reshape(-1)
    sums = torch.zeros((m * ksub, ds), dtype=torch.float32, device=xs.device)
    sums.index_add_(0, seg, xs.reshape(m * n, ds).float())
    counts = torch.zeros((m * ksub,), dtype=torch.float32, device=xs.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))
    return sums.reshape(m, ksub, ds), counts.reshape(m, ksub)


def split_subspaces(x, m: int):
    """[N, D] → [m, N, ds] (a view)."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2)


class PQCodec:
    """Trained product quantizer: ``codebooks [m, ksub, ds]`` f32, with an
    optional orthogonal OPQ ``rotation [D, D]`` applied to rows at encode
    and to queries at LUT time (``q·x == (qR)·(xR)``); ``decode`` returns
    vectors in the original space."""

    def __init__(self, codebooks, rotation=None, *, device=None):
        self.codebooks = as_tensor(codebooks, device).float()
        self.device = self.codebooks.device
        self.m, self.ksub, self.ds = self.codebooks.shape
        self.dim = self.m * self.ds
        self.rotation = (None if rotation is None else
                         as_tensor(rotation, self.device).to(self.device,
                                                             torch.float32))

    def _rotate(self, x):
        return x if self.rotation is None else x @ self.rotation

    # ------------------------------------------------------------------
    @classmethod
    def train(cls, x, m: int, *, ksub: int = 256, iters: int = 12,
              seed: int = 0, sample: int = 1 << 18,
              opq_iters: int = 0, device=None) -> "PQCodec":
        """Train on (a sample of) ``x [N, D]``; D must be divisible by m.
        opq_iters > 0 learns an OPQ rotation first, then trains the final
        codebooks in the rotated space."""
        x = as_tensor(x, device)
        n, d = x.shape
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m}")
        rng = np.random.default_rng(seed)
        if n > sample:
            rows = np.sort(rng.choice(n, size=sample, replace=False))
            x = x[torch.as_tensor(rows, device=x.device)]
            n = sample
        if opq_iters > 0:
            x0 = x.float()
            rot = torch.eye(d, dtype=torch.float32, device=x.device)
            xr = x0
            for _ in range(opq_iters):
                cdc = cls.train(xr, m, ksub=ksub, iters=max(4, iters // 2),
                                seed=seed, sample=n)
                rec = cdc.decode(cdc.encode(xr))
                u, _sv, vt = torch.linalg.svd(x0.T @ rec, full_matrices=False)
                rot = u @ vt
                xr = x0 @ rot
            codec = cls.train(xr, m, ksub=ksub, iters=iters, seed=seed,
                              sample=n)
            codec.rotation = rot
            return codec
        xs = split_subspaces(x.float(), m)                    # [m, n, ds]
        ksub_eff = min(ksub, n)
        init = np.stack([
            np.sort(rng.choice(n, size=ksub_eff, replace=False))
            for _ in range(m)
        ])                                                    # [m, ksub]
        init_t = torch.as_tensor(init, device=x.device)
        codebooks = torch.gather(
            xs, 1, init_t[:, :, None].expand(-1, -1, xs.shape[2]))
        # accumulate assignment stats over row batches
        tb = 1 << 16
        for _ in range(iters):
            sums = torch.zeros((m, ksub_eff, xs.shape[2]), dtype=torch.float32,
                               device=x.device)
            counts = torch.zeros((m, ksub_eff), dtype=torch.float32,
                                 device=x.device)
            for s in range(0, n, tb):
                xb = xs[:, s: s + tb]
                sb, cb = _pq_update_stats(
                    xb, _pq_assign(xb, codebooks), ksub_eff)
                sums, counts = sums + sb, counts + cb
            means = sums / torch.clamp(counts[:, :, None], min=1.0)
            codebooks = torch.where(counts[:, :, None] > 0, means, codebooks)
        if ksub_eff < ksub:   # tiny corpora: pad so codes stay uint8-valid
            pad = codebooks[:, :1].expand(-1, ksub - ksub_eff, -1)
            codebooks = torch.cat([codebooks, pad], dim=1)
        return cls(codebooks)

    # ------------------------------------------------------------------
    def encode(self, x, *, block: int = 1 << 20) -> torch.Tensor:
        """[N, D] → codes [N, m] uint8 on the codec's device, blocked so
        memory holds one f32 block + codes at a time."""
        x = as_tensor(x, self.device)
        out = []
        for s in range(0, x.shape[0], block):
            xb = self._rotate(x[s: s + block].to(self.device, torch.float32))
            codes = _pq_assign(split_subspaces(xb, self.m), self.codebooks)
            out.append(codes.T.to(torch.uint8))               # [Nb, m]
        if not out:
            return torch.zeros((0, self.m), dtype=torch.uint8,
                               device=self.device)
        return out[0] if len(out) == 1 else torch.cat(out)

    def decode(self, codes) -> torch.Tensor:
        """[N, m] uint8 → reconstructed [N, D] f32 (original space)."""
        codes = as_tensor(codes, self.device).long()
        sub = self.codebooks[torch.arange(self.m, device=codes.device)[None, :],
                             codes]                           # [N, m, ds]
        out = sub.reshape(codes.shape[0], self.dim)
        # rotation is orthogonal: un-rotate back to the original space
        return out if self.rotation is None else out @ self.rotation.T

    def luts(self, queries) -> torch.Tensor:
        """[B, D] → ADC lookup tables [B, m, ksub] f32 (q_sub · centroid);
        queries rotate with the codec."""
        q = self._rotate(as_tensor(queries, self.device).float())
        qs = q.reshape(q.shape[0], self.m, self.ds)
        return torch.einsum("bmd,mkd->bmk", qs, self.codebooks)

    # ------------------------------------------------------------------
    def save_arrays(self):
        out = {"codebooks": self.codebooks.cpu().numpy()}
        if self.rotation is not None:
            out["rotation"] = self.rotation.cpu().numpy()
        return out

    @classmethod
    def from_arrays(cls, arrs, *, device=None):
        return cls(arrs["codebooks"], rotation=arrs.get("rotation"),
                   device=device)


# ----------------------------------------------------------------- ADC top-k

def adc_topk(luts, codes_t, bias, n_active, *, k=10, tile=1 << 20,
             impl="auto"):
    """Approximate top-k by ADC over PQ codes.

    Args:
      luts: [B, m, ksub] f32 from ``PQCodec.luts``.
      codes_t: [m, N_pad] uint8, subspace-major.
      bias: [N_pad] f32 additive bias (NEG_INF = dead row).
      n_active: rows >= n_active are padding.
      k, tile: top-k size / corpus tile rows (tile must divide N_pad).
      impl: "kernel" (``ops.adc.adc_scores``: the CUDA kernel on CUDA
        tensors, its plain version on CPU tensors), "plain", or "auto"
        (= "kernel").
    Returns: (vals [B, k] f32, idx [B, k] int32) — idx are physical rows.
    """
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"adc_topk: unknown impl {impl!r}")
    score = plain_adc_scores if impl == "plain" else adc_scores
    b = luts.shape[0]
    n_pad = codes_t.shape[1]
    tile = min(tile, n_pad)
    if n_pad % tile:  # a silent floor would drop rows
        raise ValueError(f"adc_topk: tile {tile} does not divide {n_pad}")
    k = min(k, n_pad)
    luts_mgk = luts.permute(1, 0, 2)
    vals, idx = [], []
    for start in range(0, n_pad, tile):
        s = score(luts_mgk, codes_t[:, start:start + tile])
        s = s + bias[start:start + tile][None, :]
        col = torch.arange(start, start + tile, device=s.device)
        s = torch.where(col[None, :] < int(n_active), s,
                        torch.full_like(s, NEG_INF))
        v, p = topk_lower_first(s, min(k, tile))
        vals.append(v)
        idx.append(p + start)
    if len(vals) == 1:
        return vals[0], idx[0].to(torch.int32)
    mv, mp = topk_lower_first(torch.cat(vals, dim=1), k)
    return mv, torch.gather(torch.cat(idx, dim=1), 1, mp).to(torch.int32)


# ------------------------------------------------------------------- index

class PQFlatIndex:
    """Flat PQ index: device-resident uint8 codes + exhaustive ADC top-k.
    Rows are append-ordered physical positions, ``bias`` is indexed by row,
    capacity grows by doubling (tile-aligned)."""

    def __init__(self, codec: PQCodec, *, capacity: int = 1 << 15,
                 tile: int = 1 << 20):
        self.codec = codec
        self.device = codec.device
        self.tile = tile
        self._cap = self._round_cap(capacity)
        self.codes_t = torch.zeros((codec.m, self._cap), dtype=torch.uint8,
                                   device=self.device)
        self.n_rows = 0
        self._ids: list = []
        self._buf_lock = threading.Lock()

    def _round_cap(self, cap: int) -> int:
        t = min(self.tile, 1 << 14)
        return max(t, -(-cap // t) * t)

    def __len__(self):
        return self.n_rows

    @property
    def capacity(self):
        return self._cap

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, x, ids=None, *, m: int = 48, ksub: int = 256,
              iters: int = 12, seed: int = 0, tile: int = 1 << 20,
              codec: PQCodec | None = None, device=None) -> "PQFlatIndex":
        """Train (unless a codec is supplied) + encode a corpus in one go."""
        x = as_tensor(x, device)
        codec = codec or PQCodec.train(x, m, ksub=ksub, iters=iters,
                                       seed=seed)
        idx = cls(codec, capacity=x.shape[0], tile=tile)
        idx.add(x, ids)
        return idx

    def add(self, x, ids=None) -> np.ndarray:
        """Encode + append rows; returns their physical row numbers."""
        codes = self.codec.encode(x)                         # [n_new, m] u8
        n_new = codes.shape[0]
        with self._buf_lock:
            start = self.n_rows
            if start + n_new > self._cap:
                new_cap = self._round_cap(max(self._cap * 2, start + n_new))
                grown = torch.zeros((self.codec.m, new_cap), dtype=torch.uint8,
                                    device=self.device)
                grown[:, :start] = self.codes_t[:, :start]
                self.codes_t, self._cap = grown, new_cap
            self.codes_t[:, start:start + n_new] = codes.T
            self.n_rows = start + n_new
            self._ids.extend(range(start, start + n_new) if ids is None
                             else ids)
        return np.arange(start, start + n_new)

    # --------------------------------------------------------------- search
    def search_dispatch(self, queries, k: int = 10, *, bias=None,
                        normalize_queries: bool = True, impl="auto"):
        """Device-only ADC top-k → (vals [B,k] f32, rows [B,k] i32).
        bias is indexed by physical row ([capacity] or [n_rows],
        zero-padded here)."""
        q = as_tensor(queries, self.device).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        if normalize_queries:
            q = l2_normalize(q)
        with self._buf_lock:
            codes_t, n_rows, cap = self.codes_t, self.n_rows, self._cap
        bias_full = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        if bias is not None:
            bb = as_tensor(bias, self.device).to(self.device, torch.float32)
            bias_full[: bb.shape[0]] = bb[:cap]
        tile = min(self.tile, cap)
        while cap % tile:  # capacity is a multiple of min(tile, 16k)
            tile //= 2
        return adc_topk(self.codec.luts(q), codes_t, bias_full, n_rows, k=k,
                        tile=tile, impl=impl)

    def search(self, queries, k: int = 10, *, bias=None,
               normalize_queries: bool = True, impl="auto"):
        """→ (ids [B][k], vals [B,k] np, rows [B,k] np; None id = dead)."""
        vals, rows = self.search_dispatch(
            queries, k, bias=bias, normalize_queries=normalize_queries,
            impl=impl)
        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()
        dead = vals <= NEG_INF / 2
        ids = [[None if dead[b, j] else self._ids[int(rows[b, j])]
                for j in range(rows.shape[1])] for b in range(rows.shape[0])]
        return ids, vals, np.where(dead, -1, rows)

    # ------------------------------------------------------------ serialize
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            codes_t=self.codes_t[:, : self.n_rows].cpu().numpy(),
            **self.codec.save_arrays(),
            meta=json.dumps({
                "n_rows": self.n_rows, "tile": self.tile,
                "ids": jsonable_ids(self._ids),
            }),
        )

    @classmethod
    def load(cls, path: str, *, device=None) -> "PQFlatIndex":
        z = load_npz(path)
        meta = json.loads(str(z["meta"]))
        codec = PQCodec.from_arrays(
            {"codebooks": z["codebooks"],
             **({"rotation": z["rotation"]} if "rotation" in z else {})},
            device=device)
        idx = cls(codec, capacity=max(1, meta["n_rows"]), tile=meta["tile"])
        codes_t = torch.as_tensor(z["codes_t"], device=idx.device)
        idx.codes_t[:, : codes_t.shape[1]] = codes_t
        idx.n_rows = meta["n_rows"]
        idx._ids = list(meta["ids"])
        return idx
