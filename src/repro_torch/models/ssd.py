"""Chunked linear-recurrence engine (Mamba-2 "SSD" form).

One engine serves both recurrent families of the zoo:

  * Mamba2 / SSD:   h_t = exp(a_t)·h_{t-1} + B_t xᵀ_t ;  y_t = C_t h_t
  * mLSTM (xLSTM):  C_t = f_t·C_{t-1} + i_t·k_t vᵀ_t ;   h_t = C_t q_t
                     (q→C, k→B, i_t folded into v, log f_t → a_t)

with a per-(step, head) scalar log-decay ``a_t``.  The sequence is split
into chunks of Q steps: within a chunk a masked quadratic form, across
chunks a short loop over the chunk states (B, H, N, P).

All math in fp32 (long products of exponentials are precision-
sensitive); inputs are cast in, outputs cast back by callers.
"""
from __future__ import annotations

import torch

from .sharding import get_rules, is_dtensor, on_shards


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) log-decays -> (..., Q, Q) lower-tri cumulative sums.

    out[t, s] = Σ_{r=s+1..t} a_r  for t >= s, -inf above the diagonal.
    """
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def chunked_linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_a: torch.Tensor, *, chunk: int = 64,
                        h0: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compute y_t = q_t · h_t with h_t = exp(a_t) h_{t-1} + k_t vᵀ_t.

    q, k: (B, S, H, N); v: (B, S, H, P); log_a: (B, S, H).
    Returns (y (B, S, H, P) fp32, h_final (B, H, N, P) fp32).  The chunk
    is halved until it divides S.
    """
    b, s, h, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    chunk = max(1, chunk)
    c = s // chunk
    qc = q.reshape(b, c, chunk, h, n).float()
    kc = k.reshape(b, c, chunk, h, n).float()
    vc = v.reshape(b, c, chunk, h, p).float()
    ac = log_a.reshape(b, c, chunk, h).float()

    # --- intra-chunk (quadratic, masked by the decay kernel) -----------
    L = torch.exp(segsum(ac.transpose(2, 3)))          # (b, c, h, Q, Q)
    scores = torch.einsum("bcthn,bcshn->bchts", qc, kc)
    y_diag = torch.einsum("bchts,bcshp->bcthp", scores * L, vc)

    # --- chunk summaries ------------------------------------------------
    a_cum = torch.cumsum(ac, dim=2)                    # (b, c, Q, h)
    a_tot = a_cum[:, :, -1:, :]                        # (b, c, 1, h)
    decay_to_end = torch.exp(a_tot - a_cum)            # (b, c, Q, h)
    states = torch.einsum("bcqhn,bcqhp->bchnp",
                          kc * decay_to_end[..., None], vc)

    # --- inter-chunk recurrence over c (short loop) ---------------------
    a_chunk = torch.exp(a_tot[:, :, 0, :])             # (b, c, h)
    hst = (torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
           if h0 is None else h0.float())
    h_prevs = []                                       # state *before*
    for i in range(c):
        h_prevs.append(hst)
        hst = hst * a_chunk[:, i, :, None, None] + states[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)              # (b, c, h, n, p)

    # --- inter-chunk contribution ---------------------------------------
    decay_from_start = torch.exp(a_cum)                # (b, c, Q, h)
    y_off = torch.einsum("bcqhn,bchnp->bcqhp",
                         qc * decay_from_start[..., None], h_prevs)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hst


def linear_scan_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_a: torch.Tensor, h: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  q/k (B, H, N), v (B, H, P), log_a (B, H),
    h (B, H, N, P) -> (y (B, H, P), h_new), both fp32."""
    a = torch.exp(log_a.float())[..., None, None]
    h_new = h.float() * a + torch.einsum("bhn,bhp->bhnp", k.float(),
                                         v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), h_new)
    return y, h_new


def sharded_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """:func:`chunked_linear_scan`'s y, run on each rank's shards under a
    mesh: every sequence and head recurs on its own (the batch and the
    heads are the only split dims), where DTensor would run the scan's
    5- and 6-dim einsums op by op (torch 2.11 refuses their flattens of
    two split dims; each costs host time a chunk).  The scan itself with
    no mesh."""
    r = get_rules()
    args = (q, k, v, log_a)

    def scan(q, k, v, log_a):
        return chunked_linear_scan(q, k, v, log_a, chunk=chunk)[0]

    if r.mesh is None or not is_dtensor(v):
        return scan(*args)
    heads = [r.placements(a.shape, "batch", None, "heads", None)
             for a in args]
    return on_shards(scan, r.mesh, args, heads, heads[2])


def decode_scan_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_a: torch.Tensor, h: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`linear_scan_step`, run on each rank's shards under a mesh:
    every sequence and head steps on its own, and DTensor's einsums over
    the batch and heads flatten both dims, which torch 2.11 refuses when
    both are split.  The step itself with no mesh."""
    r = get_rules()
    args = (q, k, v, log_a, h)
    if r.mesh is None or not is_dtensor(h):
        return linear_scan_step(*args)
    heads = [r.placements(a.shape, "batch", "heads") for a in args]
    return on_shards(linear_scan_step, r.mesh, args, heads,
                     (heads[2], heads[4]))


def reference_scan(q, k, v, log_a, h0=None):
    """Naive sequential oracle for tests (fp32)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    hst = (torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
           if h0 is None else h0.float())
    ys = []
    for t in range(s):
        y, hst = linear_scan_step(q[:, t], k[:, t], v[:, t], log_a[:, t],
                                  hst)
        ys.append(y)
    return torch.stack(ys, dim=1), hst
