"""The reference's side of ``tests/test_torch_dryrun.py``: what
``parse_hlo`` and ``memory_analysis()`` say of the same calls, run in one
subprocess with 8 fake CPU devices (``_torch_ep_ranks.start_reference``).
Imports no torch."""

import json

#: the loop test: L products of (32, 128) @ (128, 128)
LOOP_LENGTHS = (2, 5)
#: the collectives test: a (2, 4) grid, each rank's operand (8, 16) f32
COLL_GRID = (2, 4)
COLL_AXES = ("data", "model")
COLL_ROWS, COLL_COLS = 8, 16
#: the steps on (2, 2) from make_rules at smoke size:
#: (name, kind, seq_len, global_batch)
STEP_ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "hubert-xlarge",
              "pixtral-12b")
STEP_SHAPES = (("t_train", "train", 32, 4), ("t_prefill", "prefill", 32, 4),
               ("t_decode", "decode", 64, 4))
STEP_GRID = (2, 2)
#: the encoder-only arch has no decode step (``shape_applicable``)
NO_DECODE = ("hubert-xlarge",)


def step_cells():
    """The (arch, step) pairs of :data:`STEP_ARCHS` x :data:`STEP_SHAPES`
    that run: no decode step of an encoder-only arch."""
    return [(arch, shape) for arch in STEP_ARCHS for shape in STEP_SHAPES
            if not (shape[1] == "decode" and arch in NO_DECODE)]


def loop_flops(L: int) -> float:
    """``parse_hlo``'s FLOPs of a ``lax.scan`` of L products, the shapes
    of ``tests/test_system.py::test_hlo_parser_trip_count_exact``."""
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_analysis import parse_hlo
    w = jnp.zeros((L, 128, 128), jnp.float32)

    def f(w, x):
        def body(x, wl):
            return jnp.tanh(x @ wl), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()
    x = jax.ShapeDtypeStruct((32, 128), jnp.float32)
    return parse_hlo(jax.jit(f).lower(w, x).compile().as_text()).flops


def collective_kinds() -> dict:
    """``parse_hlo``'s ``collective_by_kind`` of each ``shard_map``
    collective over the ``model`` axis of a (2, 4) mesh, each rank's
    operand (8, 16) f32, as the port's collectives call them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.launch.hlo_analysis import parse_hlo
    mesh = compat.make_mesh(COLL_GRID, COLL_AXES,
                            devices=jax.devices()[:8])
    rows = COLL_ROWS * COLL_GRID[0] * COLL_GRID[1]
    x = jax.ShapeDtypeStruct((rows, COLL_COLS), jnp.float32)
    bodies = {
        "psum": lambda a: jax.lax.psum(a, "model"),
        "all_gather": lambda a: jax.lax.all_gather(a, "model", axis=0,
                                                   tiled=True),
        "psum_scatter": lambda a: jax.lax.psum_scatter(
            a, "model", scatter_dimension=0, tiled=True),
        "all_to_all": lambda a: jax.lax.all_to_all(a, "model", 0, 0,
                                                   tiled=True),
    }
    out = {}
    for name, body in bodies.items():
        fn = compat.shard_map(body, mesh=mesh,
                              in_specs=P(("data", "model"), None),
                              out_specs=P(("data", "model"), None))
        text = jax.jit(fn).lower(x).compile().as_text()
        out[name] = parse_hlo(text).collective_by_kind
    return out


def step_costs() -> dict:
    """Each step of :func:`step_cells` at
    smoke size on (2, 2) from ``make_rules``, lowered as
    ``launch/dryrun.py::_build_lowered`` lowers it: ``parse_hlo``'s FLOPs
    and ``memory_analysis()``'s argument bytes."""
    import jax
    from repro import compat
    from repro.configs import SHAPES, ShapeSpec, get_smoke
    from repro.launch import dryrun
    from repro.launch.hlo_analysis import parse_hlo
    dryrun.get = get_smoke                 # the smoke configs, by name
    for name, kind, seq, batch in STEP_SHAPES:
        SHAPES[name] = ShapeSpec(name, seq, batch, kind)
    mesh = compat.make_mesh(STEP_GRID, COLL_AXES, devices=jax.devices()[:4])
    out = {}
    for arch, (name, *_) in step_cells():
        spec = dryrun.input_specs(arch, name, mesh)
        with compat.use_mesh(mesh):
            compiled = dryrun._build_lowered(spec, mesh).compile()
        out[f"{arch}/{name}"] = {
            "flops": parse_hlo(compiled.as_text()).flops,
            "argument_bytes": int(
                compiled.memory_analysis().argument_size_in_bytes)}
    return out


def run(path: str) -> None:
    """Every reference number of the test, written to ``path`` (JSON)."""
    res = {"loop": {str(L): loop_flops(L) for L in LOOP_LENGTHS},
           "collectives": collective_kinds(),
           "steps": step_costs()}
    with open(path, "w") as f:
        json.dump(res, f)
