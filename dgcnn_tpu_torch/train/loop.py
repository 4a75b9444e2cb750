"""Training and evaluation loops — the port of dgcnn_tpu/train/loop.py
(`nll_loss_and_correct` :38, the step :58-86, the epoch runners over a
batch function: `_fused_run` and `make_block_run` :270-303), and the
fold-lockstep step and epoch of dgcnn_tpu/train/cv_vmap.py:58
`_make_lockstep_body` (`masked_update` :86, `real_folds` :97, the step
and epoch reductions :106-152).

Contract with the reference:
  * loss per batch = NLL mean over the batch's real graphs; the epoch
    metric is the mean of per-batch means (a smaller final batch is
    over-weighted, as in the reference);
  * train accuracy is measured during training, with dropout active;
  * Adam with optax.adam's formula: torch.optim.Adam computes
    lr·m̂/(√v̂ + ε) with bias-corrected moments and ε outside the root.

Losses and correct counts stay on the device during an epoch and come to
the host once, at the epoch's end: no per-batch `.item()`.

Fold-lockstep: F folds train as one model of fold-stacked parameters
(`DGCNNFoldsNet`). A step backpropagates the sum of the F per-fold mean
losses, so each fold's gradient is its own, and `FoldAdam` updates only
the folds with a real graph in the step; a fold whose row is all −1 (it
has fewer steps than the longest fold) draws no dropout, takes no Adam
step and adds nothing to its epoch row.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, DGCNNNet


def nll_loss_and_correct(
    log_probs: torch.Tensor, y: torch.Tensor, graph_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked NLL (mean over real graphs) and correct-prediction count. The
    label pick is a one-hot product, as in the reference; `argmax` takes
    the first index among equal maxima. Log-probs [F, S, C] with y and
    graph_mask [F, S] give each fold's pair, [F] and [F]."""
    n = graph_mask.sum(dim=-1).clamp(min=1.0)
    onehot = torch.nn.functional.one_hot(
        y.long(), log_probs.shape[-1]
    ).to(log_probs.dtype)
    ll = (log_probs * onehot).sum(dim=-1)
    loss = -(ll * graph_mask).sum(dim=-1) / n
    pred = torch.argmax(log_probs, dim=-1)
    correct = ((pred == y.long()).to(torch.float32) * graph_mask).sum(dim=-1)
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
    `block_impl`, the COO layout's `spmm_impl`). Returns the batch's
    (loss, correct) as device scalars."""
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
        zero = torch.zeros((), device=next(net.parameters()).device)
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


# -- fold-lockstep --------------------------------------------------------


class FoldAdam:
    """Adam over a `DGCNNFoldsNet`'s fold-stacked parameters: one update
    of the whole flat buffer for all F folds, with a step count per fold.
    The formula is that of the `torch.optim.Adam` the sequential driver
    runs (`make_optimizer`), written out:

        m ← lerp(m, g, 1 − b1);  v ← v·b2 + (1 − b2)·g²
        p ← p − (lr / (1 − b1^t)) · m / (√v / √(1 − b2^t) + eps)

    with the bias corrections taken in float64 from each fold's count t.
    `step(real)` applies it to the folds whose `real` [F] entry is True
    and leaves the others' parameters, moments and counts untouched (a
    `where`, not a zero gradient: Adam would still decay the moments and
    move the weights)."""

    def __init__(self, net_f: DGCNNFoldsNet, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(net_f.parameters())
        self.flat = net_f.flat
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        f, dev = net_f.num_folds, self.flat.device
        self.steps = torch.zeros(f, dtype=torch.float32, device=dev)
        self.exp_avg = torch.zeros_like(self.flat)
        self.exp_avg_sq = torch.zeros_like(self.flat)
        # the fold of every element of the flat buffer
        folds = torch.arange(f, device=dev)[:, None]
        self.fold_of = torch.cat([folds.expand(f, p[0].numel()).reshape(-1)
                                  for p in self.params])

    @torch.no_grad()
    def step(self, real: torch.Tensor) -> None:
        grad = torch.cat([p.grad.reshape(-1) for p in self.params])
        self.steps.add_(real.to(self.steps.dtype))
        t = self.steps.double()
        step_size = (self.lr / (1.0 - self.b1 ** t)).float()[self.fold_of]
        bc2_sqrt = (1.0 - self.b2 ** t).sqrt().float()[self.fold_of]
        m = self.exp_avg.lerp(grad, 1.0 - self.b1)
        v = self.exp_avg_sq.mul(self.b2).addcmul_(grad, grad, value=1.0 - self.b2)
        denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
        p = self.flat - step_size * m / denom
        keep = real[self.fold_of]
        self.flat.copy_(torch.where(keep, p, self.flat))
        self.exp_avg.copy_(torch.where(keep, m, self.exp_avg))
        self.exp_avg_sq.copy_(torch.where(keep, v, self.exp_avg_sq))

    def fold_state(self, fold: int) -> dict:
        """Fold `fold`'s (0-based) moments and step counts in the layout of
        the sequential driver's `adam_state`: a list per key in
        `parameters()` order."""
        out = {"step": [], "exp_avg": [], "exp_avg_sq": []}
        off = 0
        for p in self.params:
            n = p.numel()
            for key, buf in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq)):
                out[key].append(buf[off : off + n].view(p.shape)[fold].cpu())
            out["step"].append(self.steps[fold].cpu())
            off += n
        return out


def lockstep_train_step(net_f: DGCNNFoldsNet, adam_f: FoldAdam, batch,
                        real: torch.Tensor, dropout_gens
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lockstep update of all folds: forward with dropout (fold f
    draws from `dropout_gens[f]`, None for a fold with no real graph) →
    per-fold masked NLL → backward of their sum → `FoldAdam` on the `real`
    folds. Returns the per-fold (loss [F], correct [F]) on the device."""
    net_f.zero_grad(set_to_none=True)
    log_probs = net_f(batch, deterministic=False, dropout_gens=dropout_gens)
    f = log_probs.shape[0]
    loss_f, correct_f = nll_loss_and_correct(
        log_probs, batch.y.view(f, -1), batch.graph_mask.view(f, -1))
    loss_f.sum().backward()
    adam_f.step(real)
    return loss_f.detach(), correct_f


def _fold_means(losses, corrects, real) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-fold (mean loss over its real steps, correct count) from the
    per-step [steps, F] values."""
    rf = real.to(torch.float32)
    loss = (torch.stack(losses) * rf).sum(0) / rf.sum(0).clamp(min=1.0)
    return loss, (torch.stack(corrects) * rf).sum(0)


def lockstep_train_epoch(net_f, adam_f, batch_fn: BatchFn, order3d: np.ndarray,
                         dropout_gens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train all folds over a host [steps, F, slots] index matrix (−1
    padded; a fold's all-(−1) row is a step it skips), each step's
    flattened [F·slots] row assembled on the device by `batch_fn`.
    Returns per-fold (mean loss, correct count) on the device."""
    net_f.train()
    device = net_f.flat.device
    orders = torch.from_numpy(order3d).to(device)
    real = (orders >= 0).any(dim=-1)  # [steps, F]
    real_host = (order3d >= 0).any(axis=-1)
    losses, corrects = [], []
    for s in range(order3d.shape[0]):
        gens = [g if r else None for g, r in zip(dropout_gens, real_host[s])]
        loss_f, correct_f = lockstep_train_step(
            net_f, adam_f, batch_fn(orders[s].reshape(-1)), real[s], gens)
        losses.append(loss_f)
        corrects.append(correct_f)
    return _fold_means(losses, corrects, real)


@torch.no_grad()
def lockstep_eval_epoch(net_f, batch_fn: BatchFn, order3d: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropout off, no gradients; per-fold (mean loss, correct count) over
    each fold's real steps."""
    net_f.eval()
    orders = torch.from_numpy(order3d).to(net_f.flat.device)
    real = (orders >= 0).any(dim=-1)
    losses, corrects = [], []
    for row in orders:
        batch = batch_fn(row.reshape(-1))
        log_probs = net_f(batch, deterministic=True)
        f = log_probs.shape[0]
        loss_f, correct_f = nll_loss_and_correct(
            log_probs, batch.y.view(f, -1), batch.graph_mask.view(f, -1))
        losses.append(loss_f)
        corrects.append(correct_f)
    return _fold_means(losses, corrects, real)


def run_lockstep_epoch(net_f, adam_f, batch_fn: BatchFn, order3d: np.ndarray,
                       test_order3d: np.ndarray, dropout_gens) -> np.ndarray:
    """One lockstep epoch of train + eval for every fold. Returns the host
    rows [F, 4] (train_loss, test_loss, train_correct, test_correct) —
    the epoch's one device-to-host transfer."""
    tr_loss, tr_correct = lockstep_train_epoch(net_f, adam_f, batch_fn, order3d,
                                               dropout_gens)
    te_loss, te_correct = lockstep_eval_epoch(net_f, batch_fn, test_order3d)
    rows = torch.stack([tr_loss, te_loss, tr_correct, te_correct], dim=-1)
    return rows.cpu().double().numpy()
