"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""

import subprocess
import sys

import pytest

from tiny_cells import ROOT
from benchmark.harness import isolation


@pytest.mark.parametrize("name, found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("pytorch_operator_tpu", True),
    ("pytorch_operator_tpu.models.llama", True),
    ("pytorch_operator_tpu_torch", False),
    ("pytorch_operator_tpu_torch.models.llama", False),
    ("jaxtyping", False), ("jax_extra", False), ("torch", False),
])
def test_top_level_names_are_compared_whole(name, found):
    assert (isolation.forbidden({name: None}) == [name]) is found


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_benchmark_and_the_port_load_no_jax():
    mods = _loaded_after(
        "import benchmark.harness.runner, benchmark.control, "
        "benchmark.reference.model, pytorch_operator_tpu_torch.parallel."
        "train, pytorch_operator_tpu_torch.models.moe")
    assert isolation.forbidden(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded_after("import benchmark.reference.model")
    assert not {m for m in mods
                if m.split(".")[0] == "pytorch_operator_tpu_torch"}
