"""1-D convolutional readout over sort-pooled node sequences — the port of
dgcnn_tpu/ops/readout.py:30 `conv1d_readout`:

    Conv1d(1, c5, kernel=C, stride=C) → ReLU → MaxPool1d(2,2)
    → Conv1d(c5, c6, kernel=w, stride=1) → ReLU → flatten

Layouts are the reference's: the pooled tensor stays [B, k, C]
(channels-last), conv5 is one matmul per retained node (w5 [C, c5]),
conv6 takes 'HIO' weights [w, c5, c6], and the result flattens [B, T, c6]
TIME-major (torch's own Conv1d would flatten channel-major).

Fold-lockstep (train/cv_vmap.py) runs F folds' batches at once: every
weight and bias then carries a leading fold axis F, the pooled tensor is
[F, B, k, C], and each fold's graphs go through that fold's weights
(`linear`: one batched product per layer over the fold axis).

Mixed precision (the reference's policy, dgcnn_tpu/ops/readout.py:41-75):
the pooled tensor and the weights come in the compute dtype and the
biases in fp32. Products take their operands in their own dtype and
multiply them widened to fp32, exactly, with fp32 sums (`matmul_f32`, the
reference's `preferred_element_type=float32`; a bf16 `torch.matmul` would
return bf16, rounding before the bias, and may reduce in reduced
precision). conv5 is fp32 from there, its bias added in fp32; conv6's
output is rounded to the compute dtype before its fp32 bias is added, as
the reference's bf16 convolution, which has no fp32 output, does. In fp32
every cast is the identity and the bits are the fp32 readout's.
"""

from __future__ import annotations

import torch


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in fp32 from operands in any float dtype (bf16 widens
    exactly; an fp32 operand is used as it is). With a leading fold axis,
    w [F, in, out] and x [F, ..., in], one batched product."""
    x, w = x.float(), w.float()
    if w.dim() == 2:
        return torch.matmul(x, w)
    f = w.shape[0]
    y = torch.bmm(x.reshape(f, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b, b [out] or, with fold-stacked weights, [F, out] added to
    y [F, ..., out] fold by fold."""
    if b.dim() == 1:
        return y + b
    return y + b.reshape(b.shape[0], *([1] * (y.dim() - 2)), b.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b for w [in, out], b [out], in fp32 (`matmul_f32`). With a
    leading fold axis, w [F, in, out] and b [F, out], x [F, ..., in] goes
    through its own fold's weights as one batched product."""
    return add_bias(matmul_f32(x, w), b)


def conv1d_readout(
    pooled: torch.Tensor,  # [B, k, C] (folds: [F, B, k, C])
    w5: torch.Tensor,  # [C, c5] (folds: [F, C, c5])
    b5: torch.Tensor,  # [c5] (folds: [F, c5])
    w6: torch.Tensor,  # [width, c5, c6]  ('HIO'; folds: [F, width, c5, c6])
    b6: torch.Tensor,  # [c6] (folds: [F, c6])
) -> torch.Tensor:
    """Returns flattened readout features [B, T*c6] (folds: [F, B, T*c6]),
    fp32. `pooled`, w5 and w6 in the compute dtype, b5 and b6 fp32."""
    dt = pooled.dtype
    h = torch.relu(linear(pooled, w5, b5))

    # MaxPool1d(2, 2): the windows tile the node axis, so the pool is a
    # reshape + pairwise select. `where(h0 >= h1, h0, h1)` (not max)
    # routes a tie's gradient to the FIRST element, torch max_pool1d's and
    # the reference's convention; degree-only datasets tie constantly.
    t2 = (h.shape[-2] // 2) * 2
    hp = h[..., :t2, :].reshape(*h.shape[:-2], t2 // 2, 2, h.shape[-1])
    h0, h1 = hp[..., 0, :], hp[..., 1, :]
    h = torch.where(h0 >= h1, h0, h1)

    # conv6, channels-last, as windows × weights: one matmul over
    # [B, T, w·c5] — no cuDNN (whose conv runs TF32 by default and whose
    # weight-gradient algorithms need not be deterministic)
    width = w6.shape[-3]
    h = h.to(dt)
    t_out = h.shape[-2] - width + 1
    win = torch.stack([h[..., j : j + t_out, :] for j in range(width)], dim=-2)
    win = win.reshape(*h.shape[:-2], t_out, width * h.shape[-1])  # [B, T, w·c5]
    w6m = w6.reshape(*w6.shape[:-3], -1, w6.shape[-1])
    out = torch.relu(add_bias(matmul_f32(win, w6m).to(dt), b6))
    return out.reshape(*out.shape[:-2], -1)
