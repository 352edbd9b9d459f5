"""Every module of the JAX package has its port in diner_tpu_torch.

A module `diner_tpu/<path>.py` is ported at `diner_tpu_torch/<path>.py`, or
at the counterpart named in COUNTERPARTS, or is on BY_DESIGN with the
reason it has none. ROADMAP.md carries the same table. This file imports
neither JAX nor either package: it reads the two trees.
"""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# JAX module -> the port's module of another name
COUNTERPARTS = {
    "models/torch_port.py": "models/lightning.py",
    "nn/torch_port.py": "nn/vgg.py",
    "mvs/torch_port.py": "mvs/checkpoint.py",
    "native/__init__.py": "kernels/__init__.py",
    "native/build.py": "kernels/build.py",
    "renderer/pallas_composite.py": "kernels/composite.py",
    "sampler/pallas_likelihood.py": "kernels/likelihood.py",
    "sampler/pallas_remap.py": "kernels/remap.py",
}

# JAX module -> why the port has no counterpart
BY_DESIGN = {
    "utils/jitinit.py": "jits flax's init on a TPU and holds the "
                        "DINER_TPU_KERNELS switch; the port builds modules "
                        "eagerly and dispatches kernels by device, with no "
                        "switch",
}


def _modules(pkg: str):
    root = REPO / pkg
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def test_every_jax_module_has_a_port():
    ported = set(_modules("diner_tpu_torch"))
    missing = [m for m in _modules("diner_tpu")
               if m not in BY_DESIGN
               and COUNTERPARTS.get(m, m) not in ported]
    assert not missing, f"JAX modules without a port: {missing}"


@pytest.mark.parametrize("table", ["counterparts", "by_design"])
def test_the_tables_name_real_modules(table):
    """Each entry names a JAX module that exists and has no port of its own
    name; each counterpart exists in the port."""
    jax_mods = set(_modules("diner_tpu"))
    ported = set(_modules("diner_tpu_torch"))
    entries = COUNTERPARTS if table == "counterparts" else BY_DESIGN
    for mod, target in entries.items():
        assert mod in jax_mods, mod
        assert mod not in ported, f"{mod} has a same-named port"
        if table == "counterparts":
            assert target in ported, target
    assert list(BY_DESIGN) == ["utils/jitinit.py"]

