"""The batch over ``dp`` and the sequence-sharded residual (Megatron-SP)
of the port on gloo ranks, at smoke size (f32), against the reference's
mesh runs and the single-rank port.

The seven cases of ``tests/_torch_sp_ranks.py`` — granite on (2, 2) by
heads with dense FSDP, granite on (1, 4) in context mode, smollm-360m
and jamba on (2, 2) from ``make_rules``, the two shapes that do not
split (a batch of 3 over two ``dp`` ranks, 7 positions over two ``tp``
ranks), granite on (2, 2) with the batch split and the dense layers
replicated, and granite on (2, 2) with the experts over "data" and the
sequence over "model" — each run the loss and its gradients (each rank's slice), the
prefill (logits, tallies, the rank's cache) and three decode steps; each
output is held against the reference's run of the same functions on a
mesh of fake devices (one subprocess for the file) and against the
single-rank port: tallies exactly, logits, loss, cache and every
gradient leaf within ``F32_TOL``. Every rank also records the shape of
the residual stream entering each block: its ``B/dp`` rows where ``dp``
divides the batch and, at train and prefill, its ``S/tp`` positions
where ``tp`` divides the sequence. A checkpoint written whole restores
onto the (2, 2) grid and gives the reference's loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_sp_ranks as h  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (rank_cache,  # noqa: E402
                                         shard_params)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
NAMES = list(h.CASES)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


def _rules(name, rank, phase="train"):
    """Case ``name``'s rules for ``rank``, placed by a grid object without
    a process group."""
    return h.port_rules(name, Grid(h.CASES[name][1], h.AXES, rank, {}),
                        phase)


@pytest.fixture(scope="module")
def trees():
    by_arch = {}
    for arch, *_ in h.CASES.values():
        if arch not in by_arch:
            jp = jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
            by_arch[arch] = jax.tree.map(np.asarray, jp)
    return {name: by_arch[arch] for name, (arch, *_) in h.CASES.items()}


@pytest.fixture(scope="module")
def single(trees):
    return {name: h.single(name, trees[name]) for name in NAMES}


@pytest.fixture(scope="module")
def runs(trees, single, tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    caches = {name: single[name]["whole_cache"] for name in NAMES}
    np.savez(d / "caches.npz", **{
        f"{name}/{k}": v for name, cache in caches.items()
        for k, v in h.flat_cache(cache).items()})
    checkpoint.save_checkpoint(str(d / "ckpt"), 1,
                               params_from_numpy(trees[h.RESTORE]),
                               n_shards=2)
    # the reference's compiles take most of the time: four processes
    parts = [NAMES[i::4] for i in range(4)]
    procs = [(ep.start_reference("_torch_sp_ranks.jax_sp",
                                 str(d / f"ref{i}.npz"), 8,
                                 str(d / "caches.npz"), names),
              str(d / f"ref{i}.npz")) for i, names in enumerate(parts)]
    try:
        ranks = run_ranks(h.sp_rank, 4, args=(trees, caches,
                                              str(d / "ckpt")),
                          timeout_s=300)
    except BaseException:
        for proc, _ in procs:
            proc.kill()
        raise
    ref = {}
    for proc, path in procs:
        ref |= ep.wait_reference(proc, path)
    return ranks, ref


def _jax_grads(ref, key, tree):
    n = len(jax.tree.leaves(tree))
    return params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(tree), [ref[f"{key}grad/{i}"] for i in range(n)]))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_leaf_match_single_rank_and_jax_mesh(
        runs, single, trees, name):
    ranks, ref = runs
    cfg = t_get_smoke(h.CASES[name][0])
    one = single[name]
    # on a batch dp does not divide, the reference's mesh run is off on
    # its tied embedding (tests/_torch_sp_ranks.py): its rules=None run
    jgrads = _jax_grads(ref, f"{name}/none/" if name in h.GRADS_WITHOUT_MESH
                        else f"{name}/", trees[name])
    sgrads = params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(trees[name]), one["grads"]))
    for r, outs in enumerate(ranks):
        out = outs[name]
        assert out["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
        np.testing.assert_array_equal(out["train_tallies"],
                                      one["train_tallies"])
        np.testing.assert_array_equal(out["train_tallies"],
                                      ref[f"{name}/train_tallies"])
        rules = _rules(name, r)
        want = leaves(shard_params(cfg, sgrads, rules, "train"))
        want_j = leaves(shard_params(cfg, jgrads, rules, "train"))
        assert len(out["grads"]) == len(want)
        for i, (g, w, wj) in enumerate(zip(out["grads"], want, want_j)):
            assert g.shape == tuple(w.shape), (r, i)
            assert _rel(g, w.numpy()) <= F32_TOL, (r, i, _rel(g, w.numpy()))
            assert _rel(g, wj.numpy()) <= F32_TOL, (r, i,
                                                    _rel(g, wj.numpy()))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_rank_cache_match_single_rank_and_jax_mesh(
        runs, single, name):
    """Whole logits and tallies on every rank; the returned cache is the
    rank's decode layout over the prompt's rows: its lanes over ``dp``,
    its KV heads when split by heads, every row in context mode."""
    ranks, ref = runs
    cfg = t_get_smoke(h.CASES[name][0])
    one = single[name]
    _, specs = tmodel.block_layout(cfg)
    for r, outs in enumerate(ranks):
        lg, tal = outs[name]["prefill"]
        np.testing.assert_array_equal(tal, one["prefill"][1])
        np.testing.assert_array_equal(tal, ref[f"{name}/prefill/tallies"])
        _close(lg, one["prefill"][0])
        _close(lg, ref[f"{name}/prefill/logits"])
        rules = _rules(name, r, "prefill")
        whole = [{k: torch.from_numpy(t) for k, t in c.items()}
                 if isinstance(c, dict) else
                 tuple(torch.from_numpy(t) for t in c)
                 for c in one["prefill_cache"]]
        if rules.attn_mode == "context":          # every row: cut lanes
            lanes = rules.batch_rows(h.CASES[name][3])
            want = [{k: t[:, lanes] for k, t in c.items()}
                    if isinstance(c, dict) else tuple(t[:, lanes] for t in c)
                    for c in whole]
        else:
            want = rank_cache(cfg, whole, rules)
        for spec, got, w in zip(specs, outs[name]["prefill_cache"], want):
            pairs = (zip(got.values(), w.values()) if isinstance(got, dict)
                     else zip(got, w))
            for a, b in pairs:
                assert a.shape == tuple(b.shape), (name, r, spec)
                _close(a, b.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_three_decode_steps_match_single_rank_and_jax_mesh(runs, single,
                                                          name):
    ranks, ref = runs
    one = single[name]
    for outs in ranks:
        for i, (lg, tal) in enumerate(outs[name]["decode"]):
            np.testing.assert_array_equal(tal, one["decode"][i][1])
            np.testing.assert_array_equal(tal,
                                          ref[f"{name}/decode/{i}/tallies"])
            _close(lg, one["decode"][i][0])
            _close(lg, ref[f"{name}/decode/{i}/logits"])


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_rows(runs, name):
    """The residual stream entering every block holds the rank's ``B/dp``
    rows where ``dp`` divides the batch, else all of them; at train and
    prefill its ``S/tp`` positions where ``tp`` divides the sequence,
    else all; one position at decode. No switch decides it: the rules'
    axes and the shapes do."""
    ranks, _ = runs
    _, shape, _, B, S = h.CASES[name]
    rules = _rules(name, 0)
    dp, tp = rules.dp_size, rules.tp_size
    b = B // dp if B % dp == 0 else B
    s = S // tp if S % tp == 0 else S
    assert rules.batch_split(B) == (dp > 1 and b < B)
    assert rules.seq_split(S, "train") == (tp > 1 and s < S)
    assert not rules.seq_split(S, "decode")
    for outs in ranks:
        got = outs[name]["shapes"]
        assert got == {"train": [(b, s)], "prefill": [(b, s)],
                       "decode": [(b, 1)]}, (name, got)


def test_the_rows_of_each_rank_tile_the_batch_and_the_sequence():
    """The ranks' blocks of the batch's rows and the sequence's positions,
    each counted once however many ranks hold it, cover every (row,
    position) once."""
    for name in NAMES:
        _, shape, _, B, S = h.CASES[name]
        blocks = set()
        for r in range(shape[0] * shape[1]):
            rules = _rules(name, r)
            b, s = rules.batch_rows(B), rules.seq_rows(S, "train")
            blocks.add((b.start, b.stop, s.start, s.stop))
        seen = np.zeros((B, S), int)
        for b0, b1, s0, s1 in blocks:
            seen[b0:b1, s0:s1] += 1
        assert (seen == 1).all(), name


def test_checkpoint_restored_onto_the_grid_gives_the_reference_loss(runs):
    """A checkpoint written whole on one device, restored onto the (2, 2)
    grid as each rank's slice (``load_checkpoint(..., rules=)``), gives
    the reference's mesh loss on the split batch and sequence."""
    ranks, ref = runs
    for outs in ranks:
        np.testing.assert_allclose(outs["restored_loss"],
                                   float(ref[f"{h.RESTORE}/loss"]),
                                   rtol=F32_TOL)
