"""Plain PyTorch versions of the Mamba2 SSD (state-space dual) scan.

Port of ``repro.kernels.ssm_scan.ref``. The recurrence (per batch b, head h):

    s_i = dA_i * s_{i-1} + dt_i * x_i ⊗ B_i          s: [P, N]
    y_i = C_i · s_i                                   y: [P]

with dA_i = exp(dt_i * A_h), A_h < 0. B/C are shared across heads.

- ``ssd_reference``: the sequential oracle, a Python loop over time.
- ``ssd_chunked_reference``: the chunked form (intra-chunk quadratic +
  inter-chunk state carry), the plain version the model runs on the CPU
  and under ``backend="ref"``; mathematically equal.

Shapes: x [B, S, H, P]; dt [B, S, H]; A [H], or [B, H] for one A per
batch row (a vmapped population folded into B); Bmat/Cmat [B, S, N].
Both return y [B, S, H, P] and the final state [B, H, P, N].

The reference's three-operand einsums are written as two-operand steps, so
that no order of contraction builds a [B, nc, Q, Q, H, P] intermediate (10.7
GB at zamba2's prefill shape); the largest here is [B, nc, Q, Q, H].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _per_row(A: torch.Tensor) -> torch.Tensor:
    """A [H] or [B, H] broadcast against dt [B, S, H]."""
    return A[None, None, :] if A.dim() == 1 else A[:, None, :]


def ssd_reference(x, dt, A, Bmat, Cmat,
                  init_state: Optional[torch.Tensor] = None):
    b, s, h, p = x.shape
    n = Bmat.shape[-1]
    dA = torch.exp(dt * _per_row(A))                          # [B,S,H]
    dtx = dt[..., None] * x                                   # [B,S,H,P]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    ys = []
    for t in range(s):
        state = state * dA[:, t, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", dtx[:, t], Bmat[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cmat[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _pad_time(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad dim 1 (time) of [B, S, ...] by n rows."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n)) if n else t


def ssd_chunked_reference(x, dt, A, Bmat, Cmat, *, chunk: int = 64,
                          init_state: Optional[torch.Tensor] = None):
    b, s, h, p = x.shape
    n = Bmat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    x, dt = _pad_time(x, pad), _pad_time(dt, pad)
    Bmat, Cmat = _pad_time(Bmat, pad), _pad_time(Cmat, pad)

    loga = (dt * _per_row(A)).float()                         # [B,S,H] (<= 0)
    dtx = (dt[..., None] * x).float()                         # [B,S,H,P]

    def rc(t):  # time axis -> (nc, chunk)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    la, dx = rc(loga), rc(dtx)
    Bc, Cc = rc(Bmat.float()), rc(Cmat.float())
    cum = torch.cumsum(la, dim=2)                             # [B,nc,Q,H]

    # intra-chunk: y[i] = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dtx_j
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,Qi,Qj,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: the upper triangle is exp(+large) = inf, and inf * 0
    # is NaN
    decay = torch.where(mask[None, None, :, :, None], decay, -torch.inf)
    L = torch.exp(decay)
    del decay
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # [B,nc,Qi,Qj]
    w = cb[..., None] * L                                     # [B,nc,Qi,Qj,H]
    del L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, dx)
    del w

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dtx_j ⊗ B_j
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)              # [B,nc,Q,H]
    sx = dec_end[..., None] * dx                              # [B,nc,Q,H,P]
    states = torch.einsum("bcjhp,bcjn->bchpn", sx, Bc)        # [B,nc,H,P,N]
    del sx
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # [B,nc,H]

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    prev = []                                     # the state BEFORE each chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # [B,nc,H,P,N]
    del prev, states

    # inter-chunk: y[i] += exp(cum_i) * C_i · S_prev
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state
