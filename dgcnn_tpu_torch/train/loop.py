"""Training and evaluation loops — the port of dgcnn_tpu/train/loop.py
(`nll_loss_and_correct` :38, the step :58-86, the epoch runners over a
batch function: `_fused_run` and `make_block_run` :270-303).

Contract with the reference:
  * loss per batch = NLL mean over the batch's real graphs; the epoch
    metric is the mean of per-batch means (a smaller final batch is
    over-weighted, as in the reference);
  * train accuracy is measured during training, with dropout active;
  * Adam with optax.adam's formula: torch.optim.Adam computes
    lr·m̂/(√v̂ + ε) with bias-corrected moments and ε outside the root.

Losses and correct counts stay on the device during an epoch and come to
the host once, at the epoch's end: no per-batch `.item()`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.models.dgcnn import DGCNNNet


def nll_loss_and_correct(
    log_probs: torch.Tensor, y: torch.Tensor, graph_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked NLL (mean over real graphs) and correct-prediction count. The
    label pick is a one-hot product, as in the reference; `argmax` takes
    the first index among equal maxima."""
    n = graph_mask.sum().clamp(min=1.0)
    onehot = torch.nn.functional.one_hot(
        y.long(), log_probs.shape[-1]
    ).to(log_probs.dtype)
    ll = (log_probs * onehot).sum(dim=-1)
    loss = -(ll * graph_mask).sum() / n
    pred = torch.argmax(log_probs, dim=-1)
    correct = ((pred == y.long()).to(torch.float32) * graph_mask).sum()
    return loss, correct


def make_optimizer(net: DGCNNNet, lr: float = 1e-3, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(b1, b2), eps=eps)


def train_step(
    net: DGCNNNet,
    optimizer: torch.optim.Optimizer,
    batch,
    dropout_gen: Optional[torch.Generator],
    **fwd_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update: forward with dropout → masked NLL → backward → Adam.
    `fwd_kw` goes to the forward (the block layout's `pool` and
    `block_impl`). Returns the batch's (loss, correct) as device scalars."""
    optimizer.zero_grad(set_to_none=True)
    log_probs = net(batch, deterministic=False, dropout_gen=dropout_gen, **fwd_kw)
    loss, correct = nll_loss_and_correct(log_probs, batch.y, batch.graph_mask)
    loss.backward()
    optimizer.step()
    return loss.detach(), correct


BatchFn = Callable[[torch.Tensor], object]


def train_epoch(net, optimizer, batch_fn: BatchFn, order2d: torch.Tensor,
                dropout_gen, **fwd_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train over the rows of an on-device [steps, slots] index matrix,
    each row assembled into a batch on the device by `batch_fn`; returns
    (mean batch loss, correct count) as device scalars."""
    net.train()
    losses, corrects = [], []
    for row in order2d:
        loss, correct = train_step(net, optimizer, batch_fn(row), dropout_gen,
                                   **fwd_kw)
        losses.append(loss)
        corrects.append(correct)
    return torch.stack(losses).mean(), torch.stack(corrects).sum()


@torch.no_grad()
def eval_epoch(net, batch_fn: BatchFn, order2d: torch.Tensor, **fwd_kw
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropout off, no gradients; (mean batch loss, correct count)."""
    net.eval()
    if order2d.shape[0] == 0:
        zero = torch.zeros((), device=order2d.device)
        return zero, zero
    losses, corrects = [], []
    for row in order2d:
        batch = batch_fn(row)
        loss, correct = nll_loss_and_correct(
            net(batch, deterministic=True, **fwd_kw), batch.y, batch.graph_mask
        )
        losses.append(loss)
        corrects.append(correct)
    return torch.stack(losses).mean(), torch.stack(corrects).sum()


def run_epoch(net, optimizer, batch_fn: BatchFn, order2d: torch.Tensor,
              test_order2d: torch.Tensor, dropout_gen, **fwd_kw) -> np.ndarray:
    """One epoch of train + eval over any layout (the counterpart of the
    reference's `_fused_run(batch_fn, ...)`): `batch_fn(row)` assembles a
    batch from a [slots] graph-id row on the device, `fwd_kw` goes to the
    forward. Returns the host row (train_loss, test_loss, train_correct,
    test_correct) — the epoch's one device-to-host transfer."""
    tr_loss, tr_correct = train_epoch(net, optimizer, batch_fn, order2d,
                                      dropout_gen, **fwd_kw)
    te_loss, te_correct = eval_epoch(net, batch_fn, test_order2d, **fwd_kw)
    row = torch.stack([tr_loss, te_loss, tr_correct, te_correct])
    return row.cpu().double().numpy()
