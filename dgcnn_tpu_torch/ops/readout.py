"""1-D convolutional readout over sort-pooled node sequences — the port of
dgcnn_tpu/ops/readout.py:30 `conv1d_readout`:

    Conv1d(1, c5, kernel=C, stride=C) → ReLU → MaxPool1d(2,2)
    → Conv1d(c5, c6, kernel=w, stride=1) → ReLU → flatten

Layouts are the reference's: the pooled tensor stays [B, k, C]
(channels-last), conv5 is one matmul per retained node (w5 [C, c5]),
conv6 takes 'HIO' weights [w, c5, c6], and the result flattens [B, T, c6]
TIME-major (torch's own Conv1d would flatten channel-major).
"""

from __future__ import annotations

import torch


def conv1d_readout(
    pooled: torch.Tensor,  # [B, k, C]
    w5: torch.Tensor,  # [C, c5]
    b5: torch.Tensor,  # [c5]
    w6: torch.Tensor,  # [width, c5, c6]  ('HIO')
    b6: torch.Tensor,  # [c6]
) -> torch.Tensor:
    """Returns flattened readout features [B, T*c6]."""
    h = torch.relu(torch.matmul(pooled, w5) + b5)

    # MaxPool1d(2, 2): the windows tile the node axis, so the pool is a
    # reshape + pairwise select. `where(h0 >= h1, h0, h1)` (not max)
    # routes a tie's gradient to the FIRST element, torch max_pool1d's and
    # the reference's convention; degree-only datasets tie constantly.
    t2 = (h.shape[1] // 2) * 2
    hp = h[:, :t2].reshape(h.shape[0], t2 // 2, 2, h.shape[2])
    h0, h1 = hp[:, :, 0], hp[:, :, 1]
    h = torch.where(h0 >= h1, h0, h1)

    # conv6, channels-last, as windows × weights: one matmul over
    # [B, T, w·c5] — no cuDNN (whose conv runs TF32 by default and whose
    # weight-gradient algorithms need not be deterministic)
    width = w6.shape[0]
    t_out = h.shape[1] - width + 1
    win = torch.stack([h[:, j : j + t_out] for j in range(width)], dim=2)
    win = win.reshape(h.shape[0], t_out, width * h.shape[2])  # [B, T, w·c5]
    out = torch.relu(torch.matmul(win, w6.reshape(-1, w6.shape[2])) + b6)
    return out.reshape(out.shape[0], -1)
