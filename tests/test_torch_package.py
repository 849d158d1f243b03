"""Guards on the port's package: it stands alone, runs on the card unless
asked for the CPU, and never falls back from a kernel to its plain version.
"""
import ast
import inspect
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_engine_defaults_to_cuda_and_refuses_to_run_without_a_card():
    from repro_torch.configs import get
    from repro_torch.serve.engine import ServingEngine
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(get("smollm_135m", smoke=True))


def test_entry_points_take_device_defaulting_to_cuda():
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.engine import ServingEngine
    for fn in (ServingEngine, init_params, init_cache, params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("path", sorted(PORT.glob("kernels/*/ops.py")),
                         ids=lambda p: p.parent.name)
def test_kernel_wrappers_hold_no_except_clause(path):
    """A launch failure must raise, never fall back to the plain result."""
    tree = ast.parse(path.read_text(), str(path))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
