"""The plain reference: DGCNN as published (Zhang, Cui, Neumann and Chen,
"An End-to-End Deep Learning Architecture for Graph Classification",
AAAI 2018) and as the reference implementation's `model.py` builds it,
with its loss and Adam, in plain PyTorch at float32 with TF32 off.

    4 × GCNConv (D̂^-1/2 (A + I) D̂^-1/2 · H · W + b, input self-loops
        removed) → tanh, widths F → 32 → 32 → 32 → 1, the four outputs
        concatenated (97 channels)
    SortPooling: each graph's k = 30 nodes of largest last channel,
        descending, ties by lower node index; fewer nodes pad with zeros
    Conv1d(1, 16, 97, stride 97) → ReLU → MaxPool1d(2, 2)
        → Conv1d(16, 32, 5) → ReLU → flatten (time-major)
    Linear(352, 128) → ReLU → Dropout(0.5) → Linear(128, C) → log_softmax
    loss: NLL, the mean over a batch's graphs

Adam (Kingma and Ba): m ← b1·m + (1 − b1)·g, v ← b2·v + (1 − b2)·g²,
p ← p − lr · m̂ / (√v̂ + eps) with the bias-corrected moments.

Nothing here imports the program. Each batch is built from the raw graphs:
the normalized adjacency is worked out again on the device, padded to
the batch's own largest graph. Dropout draws one U[0, 1) row of 128 a
graph slot from a generator seeded as the program's, `rows_for` saying
which row belongs to which graph and how many rows a step draws (the
program draws one a slot of its padded layout: reference/layout.py).

This module is the `dgcnn` family's reference (benchmark/family.py): it
also gives the published weight layout (`leaf_shapes`), from which
benchmark/inputs.py draws every fold's weights.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def leaf_shapes(model: dict, num_features: int, num_classes: int) -> list:
    """(name, shape, init bound) of every weight in the published layout:
    GCN weights [in, out] (Glorot bound, zero biases), conv5 one matmul a
    sort-pooled row [Σdims, c5], conv6 [width, c5, c6], the readout
    flattened time-major into lin1 [T·c6, dense], lin2 [dense, C]; the
    others torch's default U(±1/√fan_in). A bound of 0 is a zero leaf."""
    out, d_in = [], num_features
    for i, d in enumerate(model["hidden_dims"]):
        out += [(f"gcn.{i}.w", (d_in, d), math.sqrt(6.0 / (d_in + d))),
                (f"gcn.{i}.b", (d,), 0.0)]
        d_in = d
    cat = sum(model["hidden_dims"])
    c5, c6 = model["conv1d_channels"]
    w = model["conv1d_kernel"]
    flat = (model["sort_pool_k"] // 2 - w + 1) * c6
    dense = model["dense_dim"]
    for name, shape, fan in (("conv5.w", (cat, c5), cat), ("conv5.b", (c5,), cat),
                             ("conv6.w", (w, c5, c6), c5 * w), ("conv6.b", (c6,), c5 * w),
                             ("lin1.w", (flat, dense), flat), ("lin1.b", (dense,), flat),
                             ("lin2.w", (dense, num_classes), dense),
                             ("lin2.b", (num_classes,), dense)):
        out.append((name, shape, 1.0 / math.sqrt(fan)))
    return out


class Graphs:
    """The raw graphs, their features on `device` once."""

    def __init__(self, graphs: dict, device):
        self.device = torch.device(device)
        self.node_ptr = graphs["node_ptr"]
        self.edge_ptr = graphs["edge_ptr"]
        self.src, self.dst = graphs["edge_src"], graphs["edge_dst"]
        self.y = graphs["y"]
        self.x = torch.from_numpy(graphs["x"]).to(self.device)
        self.sizes = np.diff(self.node_ptr)

    def batch(self, ids: np.ndarray):
        """(x [B, n, F], Â [B, n, n], node mask [B, n], y [B]) of the graphs
        `ids`, n the largest of them."""
        ids = np.asarray(ids, dtype=np.int64)
        sizes = self.sizes[ids]
        b, n = len(ids), int(sizes.max())
        slot = np.repeat(np.arange(b), sizes)
        local = np.arange(len(slot)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
        nodes = np.full((b, n), -1, dtype=np.int64)
        nodes[slot, local] = np.repeat(self.node_ptr[ids], sizes) + local
        counts = self.edge_ptr[ids + 1] - self.edge_ptr[ids]
        at = np.repeat(self.edge_ptr[ids], counts) + (
            np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts))
        s, d = self.src[at].astype(np.int64), self.dst[at].astype(np.int64)
        keep = s != d  # input self-loops removed
        eb = np.repeat(np.arange(b), counts)[keep]
        dev = self.device
        nodes_t = torch.from_numpy(nodes).to(dev)
        mask = (nodes_t >= 0).float()
        x = self.x[nodes_t.clamp(min=0)] * mask[..., None]
        a = torch.zeros((b, n, n), device=dev)
        idx = tuple(torch.from_numpy(v).to(dev) for v in (eb, d[keep], s[keep]))
        a.index_put_(idx, torch.ones(len(idx[0]), device=dev), accumulate=True)
        a = a + torch.diag_embed(mask)  # one self-loop a node
        deg = a.sum(-1)
        dinv = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(), torch.zeros_like(deg))
        a = a * dinv[:, :, None] * dinv[:, None, :]
        y = torch.from_numpy(self.y[ids].astype(np.int64)).to(dev)
        return x, a, mask, y


def sort_pool(cat: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[B, n, C] → [B, k, C]: the k nodes of largest last channel,
    descending; equal keys by lower node index, +0 before −0."""
    b, n, c = cat.shape
    if n < k:
        cat = torch.cat([cat, cat.new_zeros(b, k - n, c)], dim=1)
        mask = torch.cat([mask, mask.new_zeros(b, k - n)], dim=1)
    key = torch.where(mask > 0, cat[..., -1], torch.full_like(mask, float("-inf")))
    by_sign = torch.sort(torch.signbit(key).to(torch.uint8), dim=1, stable=True).indices
    val, order = torch.sort(torch.gather(key, 1, by_sign), dim=1, descending=True,
                            stable=True)
    top = torch.gather(by_sign, 1, order[:, :k])
    pooled = torch.gather(cat, 1, top[..., None].expand(-1, -1, c))
    return pooled * torch.isfinite(val[:, :k])[..., None]


def forward(p: dict, model: dict, x, a, mask, drop_u=None) -> torch.Tensor:
    """Log-probs [B, C]; `drop_u` [B, dense] the step's U[0, 1) draws of
    its graphs (None: evaluation, no dropout)."""
    h, outs = x, []
    for i in range(len(model["hidden_dims"])):
        h = torch.tanh(a @ (h @ p[f"gcn.{i}.w"]) + p[f"gcn.{i}.b"]) * mask[..., None]
        outs.append(h)
    pooled = sort_pool(torch.cat(outs, dim=-1), mask, model["sort_pool_k"])
    z = torch.relu(pooled @ p["conv5.w"] + p["conv5.b"])  # Conv1d(1, c5, C, stride C)
    t2 = (z.shape[1] // 2) * 2
    z0, z1 = z[:, 0:t2:2], z[:, 1:t2:2]
    z = torch.where(z0 >= z1, z0, z1)  # MaxPool1d(2, 2), a tie to the first
    w6 = p["conv6.w"]  # [width, c5, c6]
    t_out = z.shape[1] - w6.shape[0] + 1
    z = sum(z[:, j:j + t_out] @ w6[j] for j in range(w6.shape[0])) + p["conv6.b"]
    z = torch.relu(z).reshape(z.shape[0], -1)  # time-major
    h = torch.relu(z @ p["lin1.w"] + p["lin1.b"])
    if drop_u is not None:
        keep = 1.0 - model["dropout_rate"]
        h = torch.where(drop_u < keep, h / keep, torch.zeros_like(h))
    return torch.log_softmax(h @ p["lin2.w"] + p["lin2.b"], dim=-1)


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products with TF32 off (the reference), or on (its control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


FAULTS = ("half", "train_half", "answer")


def _loss(log_probs, y, fault, training):
    if fault == "half" or (fault == "train_half" and training):
        # half of the batch left out, the mean over the rest (train_half:
        # in training only, the evaluation untouched)
        keep = (len(y) + 1) // 2
        log_probs, y = log_probs[:keep], y[:keep]
    if fault == "answer":  # the first graph's answer altered where it is made
        log_probs = torch.cat([log_probs[:1].roll(1, dims=-1), log_probs[1:]])
    return -log_probs.gather(1, y[:, None]).mean()


def evaluate(g: Graphs, model: dict, params: dict, test_ids: np.ndarray, batch: int,
             tf32: bool = False, fault=None) -> float:
    """The test loss (the mean of the batch means) of `params`, by name."""
    with torch.no_grad(), precision(tf32):
        p = {n: t.float() for n, t in params.items()}
        losses = []
        for s in range(0, len(test_ids), batch):
            x, a, mask, y = g.batch(test_ids[s:s + batch])
            losses.append(_loss(forward(p, model, x, a, mask), y, fault, False))
        return float(torch.stack(losses).mean())


def follow(g: Graphs, model: dict, train: dict, params0: dict, epoch_ids: list,
           test_ids: np.ndarray, dropout_seed: int, rows_for, tf32: bool = False,
           fault=None) -> dict:
    """Train one fold from `params0` over the epochs' training orders
    `epoch_ids` (batches of `batch_size` in that order), evaluating on
    `test_ids` after each epoch. `rows_for(epoch, ids)` gives a training
    batch's dropout rows (one a graph) and the rows the step draws.
    Returns each epoch's train and test loss (the mean of the batch
    means), Adam's first and second moments after epoch 1 (`m1`, `v1`)
    and the weights after the last epoch, by leaf name. `fault` plants
    one of `FAULTS`."""
    dev = g.device
    names = list(params0)  # the published leaf order (inputs.leaf_shapes)
    shapes = [params0[n].shape for n in names]
    sizes = [int(np.prod(s)) for s in shapes]
    theta = torch.cat([params0[n].detach().reshape(-1).float() for n in names]).clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    b1, b2 = train["adam_b1"], train["adam_b2"]
    lr, eps, bs = train["learning_rate"], train["adam_eps"], train["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(int(dropout_seed))
    dense = model["dense_dim"]
    out = {"train_loss": [], "test_loss": []}
    step = 0

    def leaves(flat):
        return {n: t.view(s) for n, t, s in zip(names, torch.split(flat, sizes), shapes)}

    with precision(tf32):
        for e, ids in enumerate(epoch_ids):
            losses = []
            for s in range(0, len(ids), bs):
                batch = ids[s:s + bs]
                rows, total = rows_for(e, batch)
                u = torch.rand((total, dense), generator=gen, device=dev)
                x, a, mask, y = g.batch(batch)
                flat = theta.clone().requires_grad_(True)
                lp = forward(leaves(flat), model, x, a, mask,
                             u[torch.as_tensor(rows, device=dev)])
                loss = _loss(lp, y, fault, True)
                (grad,) = torch.autograd.grad(loss, flat)
                step += 1
                with torch.no_grad():
                    m = b1 * m + (1.0 - b1) * grad
                    v = b2 * v + (1.0 - b2) * grad * grad
                    m_hat = m / (1.0 - b1 ** step)
                    v_hat = v / (1.0 - b2 ** step)
                    theta = theta - lr * m_hat / (v_hat.sqrt() + eps)
                losses.append(loss.detach())
            out["train_loss"].append(float(torch.stack(losses).mean()))
            out["test_loss"].append(evaluate(g, model, leaves(theta), test_ids, bs, tf32, fault))
            if e == 0:
                out["m1"] = {n: t.clone() for n, t in leaves(m).items()}
                out["v1"] = {n: t.clone() for n, t in leaves(v).items()}
    out["params"] = {n: t.clone() for n, t in leaves(theta).items()}
    return out
