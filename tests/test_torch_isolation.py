"""The port stands alone: no JAX, no reference package, copies that match.

* No file under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (the name exactly; ``repro_torch`` is the port).
* Each module copied from the reference (configs, core, the numpy serving
  modules and the drills, ``training/data.py`` and ``training/elastic.py``)
  equals its original once ``repro.`` reads ``repro_torch.``, so a copy
  cannot drift silently.
* The port's controller (its copy of ``repro.core``) reaches the same
  placement as the reference's after the same tallies.
"""

import ast
import pathlib

import numpy as np
import pytest

from repro import core as jcore
from repro_torch import core as tcore

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
REF = REPO / "src" / "repro"

COPIED = sorted(
    [p.relative_to(PORT) for p in (PORT / "configs").glob("*.py")]
    + [p.relative_to(PORT) for p in (PORT / "core").glob("*.py")]
    + [pathlib.Path("serving") / f"{m}.py" for m in
       ("config", "kvcache", "metrics", "scheduler", "workload",
        "simulator", "elastic", "faults")]
    + [pathlib.Path("training") / f"{m}.py" for m in ("data", "elastic")])


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    # the training slice is in the walk
    for rel in ("launch/train.py", "training/optimizer.py",
                "training/checkpoint.py", "training/__init__.py"):
        assert PORT / rel in files
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f)
                                            & {"jax", "repro"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_copied_modules_equal_their_originals():
    assert len(COPIED) == 13 + 11 + 8 + 2
    for rel in COPIED:
        original = (REF / rel).read_text().replace("repro.", "repro_torch.")
        assert (PORT / rel).read_text() == original, f"{rel} drifted"


@pytest.mark.parametrize("policy", ["vibe", "vibe_r"])
def test_controller_copy_places_like_the_reference(policy):
    L, E, G = 3, 8, 4
    rng = np.random.default_rng(11)

    def controller(core):
        cluster = core.make_cluster(G, "mi325x", d_model=128, d_ff=64,
                                    experts_per_rank=E // G, seed=0)
        return core.ViBEController(
            L, E, G, cluster.fit_models(),
            core.ViBEConfig(policy=policy,
                            drift=core.DriftConfig(window=8, interval=4,
                                                   cooldown=4),
                            expert_bytes=3 * 128 * 64 * 2))

    cj, ct = controller(jcore), controller(tcore)
    # a shifted, skewed routing profile so the drift detector fires
    for step in range(40):
        alpha = np.full(E, 0.3) if step < 20 else np.linspace(3, 0.1, E)
        tallies = np.stack([rng.multinomial(64, rng.dirichlet(alpha))
                            for _ in range(L)]).astype(np.float64)
        uj = cj.observe(tallies, tokens=32.0)
        ut = ct.observe(tallies, tokens=32.0)
        assert (uj is None) == (ut is None)
    assert len(ct.updates) == len(cj.updates) > 0
    np.testing.assert_array_equal(ct.placement.perm, cj.placement.perm)
    np.testing.assert_array_equal(ct.placement.share, cj.placement.share)
