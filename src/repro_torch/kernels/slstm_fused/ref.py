"""Plain PyTorch version of the fused sLSTM recurrence.

Port of ``repro.kernels.slstm_fused.ref``. The inputs are the gate
pre-activations (the parallel ``x @ W_in`` part is computed outside):
``pre [B, S, 4, H, P]`` in the gate order (z, i, f, o), and the head-wise
recurrent weights ``r [4, H, P, P]``. Stabilised exponential gating, as in
the xLSTM paper (Sec 3.1):

    m_t = max(logsig(f_pre) + m_{t-1}, i_pre)
    i = exp(i_pre - m_t); f = exp(logsig(f_pre) + m_{t-1} - m_t)
    c = f c + i tanh(z);  n = f n + i;  h = sigmoid(o) * c / max(n, 1e-6)

where each gate's pre-activation adds ``h_{t-1} @ r[g, head]``. The state
starts from h = c = n = 0 and m = -1e30, so the first step's forget gate is
exactly 0. Returns h over time ``[B, S, H, P]`` and the final state, a dict
of ``h``, ``c``, ``n``, ``m``, each ``[B, H, P]``, all float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def cell_step(pre_t: torch.Tensor, rec: torch.Tensor,
              st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One step from pre_t and rec = h_{t-1} @ r, both [B, 4, H, P]."""
    z_pre = pre_t[:, 0] + rec[:, 0]
    i_pre = pre_t[:, 1] + rec[:, 1]
    f_pre = pre_t[:, 2] + rec[:, 2]
    o_pre = pre_t[:, 3] + rec[:, 3]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st["m"], i_pre)
    i_act = torch.exp(i_pre - m_new)
    f_act = torch.exp(logf + st["m"] - m_new)
    c = f_act * st["c"] + i_act * torch.tanh(z_pre)
    n = f_act * st["n"] + i_act
    h_new = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"h": h_new, "c": c, "n": n, "m": m_new}


def slstm_reference(pre: torch.Tensor, r: torch.Tensor,
                    state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pre [B, S, 4, H, P]; r [4, H, P, P] -> (h [B, S, H, P], state).

    A Python loop over S with one batched product a step; float64 inputs
    stay float64 (an oracle), anything else computes in float32."""
    dtype = torch.float64 if pre.dtype == torch.float64 else torch.float32
    b, s, _, h, p = pre.shape
    if state is None:
        z = torch.zeros((b, h, p), dtype=dtype, device=pre.device)
        state = {"h": z, "c": z, "n": z, "m": torch.full_like(z, -1e30)}
    st = {k: v.to(dtype) for k, v in state.items()}
    pre, r = pre.to(dtype), r.to(dtype)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhp,ghpq->bghq", st["h"], r)
        st = cell_step(pre[:, t], rec, st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st
