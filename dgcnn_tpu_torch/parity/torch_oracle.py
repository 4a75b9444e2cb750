"""Plain-PyTorch oracle of the full reference network (the reference
PyG model, reference model.py:9-45) — the port's own copy of
dgcnn_tpu/parity/torch_oracle.py (`forward_activations`,
`train_trajectory`, `graphs_from_graphset`).

PyG itself is not installable here, so the golden-parity target is
transliterated from PyG's documented algorithms into plain torch ops, no
torch_geometric import:

  * `GCNConv` default semantics (reference model.py:5,13-16): strip no
    loops itself (the model calls `remove_self_loops` once, model.py:28),
    add exactly one self-loop per node, symmetric normalization
    deg^{-1/2}[src]·deg^{-1/2}[dst] over the self-looped graph, propagate
    `X Θ` rows by scatter-add into destinations, then + bias — the
    compute PyG's `gcn_norm` + `propagate` perform with `normalize=True,
    add_self_loops=True, improved=False, cached=False`.
  * `SortAggregation(k)` (model.py:17,35): per graph, order nodes
    DESCENDING by the last feature channel, ties keeping original node
    order (stable sort), truncate to k, zero-pad graphs with < k nodes.
  * readout head: real `torch.nn.functional` conv1d / max_pool1d / linear
    on the converted state_dict (channel-major flatten, model.py:36-43).

Weights arrive through `parity.convert.params_to_torch_state`, so the
oracle reads the same state_dict layout a pinned-PyG `Model.state_dict()`
would. Graphs come from the port's `GraphSet` (`graphs_from_graphset`).
The computation is the reference oracle's, op for op, so the two give the
same bits (tests/test_torch_parity_harness.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _gcn_conv(
    x: torch.Tensor,      # [n, f] fp32
    w: torch.Tensor,      # [out, in] torch Linear layout (conv{i}.lin.weight)
    b: torch.Tensor,      # [out]
    src: torch.Tensor,    # [e] int64, self-loops already stripped
    dst: torch.Tensor,    # [e] int64
) -> torch.Tensor:
    """One PyG-default GCNConv: X' = D̂^{-1/2}(A+I)D̂^{-1/2} X Θ + b."""
    n = x.shape[0]
    h = torch.nn.functional.linear(x, w)  # X Θ (PyG lin has no bias)
    # self-looped degree: in-degree over dst + 1 (gcn_norm counts the dst
    # column; TU graphs are stored symmetrically so in == out)
    deg = torch.zeros(n, dtype=x.dtype).index_add_(
        0, dst, torch.ones(dst.shape[0], dtype=x.dtype)
    ) + 1.0
    dinv_sqrt = deg.pow(-0.5)
    norm = dinv_sqrt[src] * dinv_sqrt[dst]  # [e]
    out = torch.zeros_like(h).index_add_(0, dst, h[src] * norm[:, None])
    # the re-added self-loop term: deg^{-1/2}_i · 1 · deg^{-1/2}_i · h_i
    out = out + h * (1.0 / deg)[:, None]
    return out + b


def _sort_pool(xs: List[torch.Tensor], k: int) -> torch.Tensor:
    """SortAggregation(k) over a list of per-graph [n_g, C] tensors →
    [B, k, C]: stable descending sort by channel −1, truncate/zero-pad."""
    pooled = []
    for xg in xs:
        # stable=True pins tie order to original node index — the contract
        # ops/sort_pool.py reproduces (PyG's dense sort keeps insertion
        # order for equal keys on contiguous CPU tensors)
        order = torch.argsort(xg[:, -1], descending=True, stable=True)
        xg = xg[order][:k]
        if xg.shape[0] < k:
            xg = torch.cat(
                [xg, torch.zeros(k - xg.shape[0], xg.shape[1], dtype=xg.dtype)]
            )
        pooled.append(xg)
    return torch.stack(pooled)


def _strip_self_loops(
    src: torch.Tensor, dst: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    keep = src != dst  # reference model.py:28 remove_self_loops
    return src[keep], dst[keep]


def _forward(
    st: Dict[str, torch.Tensor],
    graphs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],  # (x, src, dst)
    k: int,
    num_gcn_layers: int,
) -> Tuple[Dict[str, List[torch.Tensor]], torch.Tensor, torch.Tensor]:
    """Differentiable reference forward (model.py:26-45) on torch tensors →
    (per-layer activation lists, pooled [B,k,C], log_probs [B,classes])."""
    acts: Dict[str, List[torch.Tensor]] = {
        f"gcn{i + 1}": [] for i in range(num_gcn_layers)
    }
    per_graph_cat: List[torch.Tensor] = []

    for x_np, src_np, dst_np in graphs:
        x = torch.as_tensor(np.asarray(x_np, np.float32))
        src = torch.as_tensor(np.asarray(src_np)).long()
        dst = torch.as_tensor(np.asarray(dst_np)).long()
        src, dst = _strip_self_loops(src, dst)
        layer_outs = []
        h = x
        for i in range(num_gcn_layers):
            h = torch.tanh(
                _gcn_conv(
                    h, st[f"conv{i + 1}.lin.weight"], st[f"conv{i + 1}.bias"],
                    src, dst,
                )
            )
            layer_outs.append(h)
            acts[f"gcn{i + 1}"].append(h)
        per_graph_cat.append(torch.cat(layer_outs, dim=-1))

    pooled = _sort_pool(per_graph_cat, k)  # [B, k, C]

    # readout head on the REAL torch ops (reference model.py:36-43)
    b = pooled.shape[0]
    cat_dim = pooled.shape[2]
    t = pooled.reshape(b, 1, -1)
    t = torch.relu(
        torch.nn.functional.conv1d(
            t, st["conv5.weight"], st["conv5.bias"], stride=cat_dim
        )
    )
    t = torch.nn.functional.max_pool1d(t, 2, 2)
    t = torch.relu(
        torch.nn.functional.conv1d(t, st["conv6.weight"], st["conv6.bias"])
    )
    t = t.reshape(b, -1)  # channel-major flatten (model.py:40)
    t = torch.relu(
        torch.nn.functional.linear(
            t, st["classifier_1.weight"], st["classifier_1.bias"]
        )
    )
    t = torch.nn.functional.linear(
        t, st["classifier_2.weight"], st["classifier_2.bias"]
    )
    return acts, pooled, torch.log_softmax(t, dim=-1)


@torch.no_grad()
def forward_activations(
    state: Dict[str, np.ndarray],   # params_to_torch_state output
    graphs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],  # (x, src, dst)
    k: int = 30,
    num_gcn_layers: int = 4,
) -> Dict[str, np.ndarray]:
    """Full reference forward over a list of graphs → the same activation
    dict layout as parity.harness.dump_activations (real rows only):
    gcn1..gcnL [ΣN, C], sort_pool [B, k, ΣC], log_probs [B, classes]."""
    st = {kk: torch.as_tensor(np.array(v)) for kk, v in state.items()}
    acts, pooled, log_probs = _forward(st, graphs, k, num_gcn_layers)
    out = {kk: torch.cat(v).numpy() for kk, v in acts.items()}
    out["sort_pool"] = pooled.numpy()
    out["log_probs"] = log_probs.numpy()
    return out


def train_trajectory(
    state: Dict[str, np.ndarray],   # params_to_torch_state output
    graphs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],  # (x, src, dst)
    labels: np.ndarray,             # [B] int graph labels
    num_steps: int = 5,
    lr: float = 1e-3,
    k: int = 30,
    num_gcn_layers: int = 4,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The reference TRAINING step, run for `num_steps` full-batch steps:
    NLL loss on the log-probs → backward → `torch.optim.Adam` with all-default
    hyperparameters (lr=1e-3, betas=(0.9, 0.999), eps=1e-8) → zero_grad —
    exactly reference train.py:39-42 with dropout disabled (the one
    framework-nondeterministic op; its masking semantics are pinned
    separately in tests/test_model.py).

    Returns (per-step losses [num_steps], final state_dict arrays) so the
    JAX step's loss AND parameter trajectories can be checked against
    torch autograd + torch Adam — the backward/optimizer halves of the
    golden-parity contract (forward halves: forward_activations above).
    """
    st = {
        kk: torch.as_tensor(np.array(v)).clone().requires_grad_(True)
        for kk, v in state.items()
    }
    opt = torch.optim.Adam(list(st.values()), lr=lr)
    y = torch.as_tensor(np.asarray(labels)).long()
    losses = []
    for _ in range(num_steps):
        _, _, log_probs = _forward(st, graphs, k, num_gcn_layers)
        loss = torch.nn.functional.nll_loss(log_probs, y)  # train.py:39
        loss.backward()        # train.py:40
        opt.step()             # train.py:41
        opt.zero_grad()        # train.py:42
        losses.append(float(loss.detach()))
    final = {kk: v.detach().numpy() for kk, v in st.items()}
    return np.asarray(losses, np.float64), final


def graphs_from_graphset(gs) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """GraphSet → per-graph (x, edge_src, edge_dst) with graph-local ids."""
    out = []
    for g in range(gs.num_graphs):
        n0, n1 = int(gs.node_ptr[g]), int(gs.node_ptr[g + 1])
        e0, e1 = int(gs.edge_ptr[g]), int(gs.edge_ptr[g + 1])
        out.append((gs.x[n0:n1], gs.edge_src[e0:e1], gs.edge_dst[e0:e1]))
    return out
