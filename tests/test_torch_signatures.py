"""The port's public signatures against the JAX package's, module by module.

For every module of ``artist_tpu`` with a counterpart under the same relative path
in ``artist_tpu_torch``, each public function and each public class's ``__init__``
and public methods that both modules define are compared with ``inspect``:

- every parameter of the JAX signature is in the port's, of the same kind (a
  ``*args`` or ``**kwargs`` by kind alone), with an equal default;
- the parameters both have come in the same order;
- a parameter only the port has carries a default (a script written for the JAX
  package never passes it).

So a script written for ``artist_tpu`` calls the port the same way. The
differences kept on purpose are :data:`DELIBERATE`, each with its reason; a
further test holds that each of them still differs, so the list cannot outlive
its cause.
"""

import dataclasses
import importlib
import inspect
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE = REPO / "artist_tpu"
PORT_PACKAGE = REPO / "artist_tpu_torch"

# (module path under the packages, qualified name) -> why the port differs.
DELIBERATE = {
    ("scene/sun.py", "Sun.get_distortions"): (
        "a torch.Generator in place of a jax.random key: torch cannot reproduce jax.random"
    ),
    ("field/heliostat_group.py", "align_surfaces_with_incident_ray_directions"): (
        "no warn_sharding: the port's tensors carry no JAX sharding to warn of"
    ),
    ("field/kinematics_rigid_body.py", "incident_ray_directions_to_orientations"): (
        "no warn_sharding, as above"
    ),
    ("optim/checkpointing.py", "unpack_pytree"): (
        "no template: the port records the structure it packs"
    ),
    **{
        ("parallel/collectives.py", name): "no tag: torch.distributed's collectives need no key to pair calls"
        for name in ("all_gather_object", "all_reduce_min", "all_reduce_sum", "barrier", "broadcast_object",
                     "synchronize_group_results")
    },
    ("parallel/mesh.py", "make_mesh"): (
        "no devices or axis_names: a torch DeviceMesh is built over the process group's ranks "
        "with the port's fixed axes"
    ),
    ("parallel/mesh.py", "fetch_global"): (
        "a torch tensor does not carry its sharding: the caller passes it and the global shape"
    ),
}


def module_pairs() -> list[str]:
    """The modules under both packages, by path relative to the package."""
    return sorted(
        str(path.relative_to(JAX_PACKAGE))
        for path in JAX_PACKAGE.rglob("*.py")
        if (PORT_PACKAGE / path.relative_to(JAX_PACKAGE)).is_file()
    )


def import_pair(relative: str):
    parts = pathlib.Path(relative).with_suffix("").parts
    name = ".".join(part for part in parts if part != "__init__")
    suffix = f".{name}" if name else ""
    return importlib.import_module(f"artist_tpu{suffix}"), importlib.import_module(f"artist_tpu_torch{suffix}")


def public_callables(module) -> dict:
    """The public functions the module defines, and its public classes' ``__init__`` and
    public methods, by qualified name."""
    found = {}
    for name, value in vars(module).items():
        if name.startswith("_") or getattr(value, "__module__", None) != module.__name__:
            continue
        if inspect.isfunction(value):
            found[name] = value
        elif inspect.isclass(value):
            for method, function in vars(value).items():
                if inspect.isfunction(function) and (method == "__init__" or not method.startswith("_")):
                    found[f"{name}.{method}"] = function
    return found


def same_default(a, b) -> bool:
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return type(a) is type(b) and a == b


VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def signature_faults(jax_function, port_function) -> list[str]:
    """Where the port's signature breaks a call written for the JAX one."""
    theirs = list(inspect.signature(jax_function).parameters.values())
    ours = list(inspect.signature(port_function).parameters.values())
    by_kind = {p.kind: p for p in ours if p.kind in VARIADIC}
    by_name = {p.name: p for p in ours if p.kind not in VARIADIC}
    faults = []
    for parameter in theirs:
        if parameter.kind in VARIADIC:
            if parameter.kind not in by_kind:
                faults.append(f"no {parameter}")
            continue
        mine = by_name.get(parameter.name)
        if mine is None:
            faults.append(f"no parameter {parameter.name}")
        elif mine.kind != parameter.kind:
            faults.append(f"{parameter.name} is {mine.kind.description}, not {parameter.kind.description}")
        elif not same_default(mine.default, parameter.default):
            faults.append(f"{parameter.name} defaults to {mine.default!r}, not {parameter.default!r}")
    shared = [p.name for p in theirs if p.name in by_name]
    if [p.name for p in ours if p.name in shared] != shared:
        faults.append(f"the shared parameters come in another order: {[p.name for p in ours]}")
    named = {p.name for p in theirs}
    faults += [
        f"{p.name} is the port's own and has no default"
        for p in ours
        if p.kind not in VARIADIC and p.name not in named and p.default is inspect.Parameter.empty
    ]
    return faults


@pytest.fixture(scope="module")
def jax_on_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("relative", module_pairs())
def test_public_signatures_match_the_jax_package(relative, jax_on_cpu):
    jax_module, port_module = import_pair(relative)
    theirs, ours = public_callables(jax_module), public_callables(port_module)
    faults = {
        name: signature_faults(theirs[name], ours[name])
        for name in sorted(theirs.keys() & ours.keys())
        if (relative, name) not in DELIBERATE
    }
    assert not {name: found for name, found in faults.items() if found}


@pytest.mark.parametrize("entry", sorted(DELIBERATE), ids=lambda entry: f"{entry[0]}::{entry[1]}")
def test_each_deliberate_difference_still_differs(entry, jax_on_cpu):
    relative, name = entry
    jax_module, port_module = import_pair(relative)
    theirs, ours = public_callables(jax_module), public_callables(port_module)
    assert name in theirs and name in ours
    assert signature_faults(theirs[name], ours[name])


def test_the_repaired_signatures_behave_as_the_jax_package():
    """The four signatures that differed until they were repaired: the JAX defaults and
    returns, the accepted-and-ignored arguments changing nothing."""
    import tempfile

    import torch

    from artist_tpu_torch.io.checkpoint import CheckpointManager
    from artist_tpu_torch.optim.checkpointing import LoopCheckpointer
    from artist_tpu_torch.raytracing.splatting import bilinear_splat

    with tempfile.TemporaryDirectory() as directory:
        manager = CheckpointManager(directory, max_to_keep=2, per_process=True)
        assert manager.save(1, {"x": np.arange(3)}, force=True) is True
        manager.wait_until_finished()
        np.testing.assert_array_equal(manager.restore()["x"], np.arange(3))
        manager.close()
        loop = LoopCheckpointer(directory, "loop", every=1, per_process=True)
        loop.save(2, {"y": np.ones(2)})
        assert int(loop.restore_latest()["epoch"]) == 2
    rng = np.random.RandomState(0)
    e, u = (torch.tensor(rng.uniform(0, 15, (2, 50)).astype(np.float32)) for _ in range(2))
    w = torch.tensor(rng.rand(2, 50).astype(np.float32))
    torch.testing.assert_close(
        bilinear_splat(e, u, w, (16, 16), method="pallas_fp32"), bilinear_splat(e, u, w, (16, 16)), rtol=0, atol=0
    )
