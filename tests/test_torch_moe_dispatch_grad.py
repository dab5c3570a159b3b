"""The MoE dispatch's backward is a fixed-order sum (ROADMAP C23).

``blocks.dispatch_rows`` repeats each token row ``top_k`` times by
expanding a new axis. The dispatch used to index ``flat`` with a
repeating token index, whose backward accumulates ``top_k`` rows per
token with ``index_put_`` in an order CUDA does not fix. On the
qwen2-moe-a2.7b smoke config in float32, on the CPU:

- the rows are bit-equal to that index's, for one and two groups;
- their gradient is, bit for bit, the upstream gradient summed over
  the ``top_k`` axis;
- the autograd graph of the MoE model's loss holds no index node
  (``IndexBackward0``, ``IndexPutBackward0``) on a float path;
- ``moe_ffn`` gives the same output and aux bits with the parent's
  index in place of ``dispatch_rows``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import blocks, build_lm
from repro_torch.models.params import leaves, map_tree

ARCH = "qwen2-moe-a2.7b"
INDEX_NODES = {"IndexBackward0", "IndexPutBackward0"}


def _cfg(**reps):
    return dataclasses.replace(get_arch(ARCH, smoke=True),
                               param_dtype="float32", **reps)


def _index_rows(flat, groups, top_k):
    """The parent's dispatch rows: an index with repeats."""
    T, D = flat.shape
    tok = torch.arange(T // groups).repeat_interleave(top_k)
    return flat.reshape(groups, T // groups, D)[:, tok]


def _graph_names(root) -> set:
    seen, names, todo = set(), set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(node.name())
        todo.extend(n for n, _ in node.next_functions)
    return names


@pytest.mark.parametrize("groups", [1, 2])
def test_dispatch_rows_and_their_fixed_order_gradient(groups):
    k = _cfg().moe.top_k
    rng = np.random.default_rng(0)
    T, D = 32, _cfg().d_model
    flat = torch.from_numpy(rng.standard_normal((T, D), dtype=np.float32))
    flat.requires_grad_()
    rows = blocks.dispatch_rows(flat, groups, k)
    want = _index_rows(flat, groups, k)
    assert rows.shape == (groups, T // groups * k, D)
    assert torch.equal(rows, want)
    assert not INDEX_NODES & _graph_names(rows.grad_fn)
    assert "IndexBackward0" in _graph_names(want.grad_fn)
    up = torch.from_numpy(rng.standard_normal(tuple(rows.shape),
                                              dtype=np.float32))
    (got,) = torch.autograd.grad(rows, flat, up)
    summed = up.reshape(groups, T // groups, k, D).sum(2).reshape(T, D)
    assert torch.equal(got, summed)


def test_moe_loss_graph_has_no_index_accumulate():
    cfg = _cfg(remat=False)
    lm = build_lm(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(flat)
    tree = map_tree(lambda _: next(it), params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                           dtype=np.int32))
    loss, _ = lm.loss(tree, {"tokens": tokens, "labels": tokens})
    names = _graph_names(loss.grad_fn)
    # the walk reaches the dispatch and the combine
    assert {"ScatterBackward0", "GatherBackward0",
            "ExpandBackward0"} <= names, sorted(names)
    assert not INDEX_NODES & names, sorted(INDEX_NODES & names)


def test_moe_ffn_forward_bits_equal_the_parents(monkeypatch):
    cfg = _cfg()
    lm = build_lm(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    moe = params["layers"]["pos0"]["moe"]
    p = map_tree(lambda t: t[0], moe)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model),
                                             dtype=np.float32))
    outs = []
    for rows in (blocks.dispatch_rows, _index_rows):
        monkeypatch.setattr(blocks, "dispatch_rows", rows)
        for groups in (1, 2):
            out, aux = blocks.moe_ffn(p, x, cfg, num_groups=groups)
            outs.append((out, aux))
    for (a, aux_a), (b, aux_b) in zip(outs[:2], outs[2:]):
        assert torch.equal(a, b)
        assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
