"""The port's copy of the Nezha store (``repro_torch.core``).

Each module is the JAX package's ``repro.core`` module with the import
prefix changed and one docstring line naming its source; driven with the
same seed and the same operations, the two ``Cluster``s give the same
answers and write the same bytes.
"""
import re
from pathlib import Path

import pytest

from repro.core.cluster import Cluster as JaxCluster
from repro_torch.core.cluster import Cluster

ROOT = Path(__file__).resolve().parents[1]
COPIED = sorted(p.stem for p in (ROOT / "src/repro_torch/core").glob("*.py")
                if p.stem != "__init__")
NOT_COPIED = ("shards", "workload")   # not reached by the training path


def test_the_copy_is_the_set_cluster_and_metrics_reach():
    assert COPIED == sorted([
        "sorteddict", "trace", "metrics", "cache", "faultfs", "valuelog",
        "minilsm", "storage", "simnet", "raft", "engines", "client",
        "shipping", "cluster"])
    imported = set()
    for m in COPIED:
        text = (ROOT / f"src/repro_torch/core/{m}.py").read_text()
        for sub, name in re.findall(
                r"from repro_torch\.core(?:\.(\w+))? import (\w+)", text):
            imported.add(sub or name)
    assert imported <= set(COPIED)
    assert not set(NOT_COPIED) & set(COPIED)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_differs_only_in_import_prefix_and_source_line(module):
    copy = (ROOT / f"src/repro_torch/core/{module}.py").read_text()
    source = (ROOT / f"src/repro/core/{module}.py").read_text()
    line = (f"\nCopied from ``src/repro/core/{module}.py``; only the import "
            f"prefix differs.\n")
    assert copy.count(line) == 1
    back = copy.replace(line, "")
    back = re.sub(r"^(\s*)(from|import) repro_torch\.core\b",
                  r"\1\2 repro.core", back, flags=re.M)
    assert back == source
    assert "repro.core" not in "".join(
        ln for ln in copy.splitlines(keepends=True)
        if re.match(r"\s*(from|import) ", ln))


def _drive(cluster_cls, workdir):
    c = cluster_cls(n=3, engine="nezha", workdir=workdir, seed=11,
                    engine_kwargs={"gc_threshold": 4 << 10})
    try:
        c.elect()
        c.put_many([(f"k{i:04d}".encode(), f"v{i}".encode() * (i % 7 + 1))
                    for i in range(300)], window=8, batch=4)
        for i in range(0, 300, 3):
            c.put(f"k{i:04d}".encode(), b"over" * (i % 5 + 1))
        scan = c.scan(b"k0000", b"k9999")
        got = [c.get(f"k{i:04d}".encode()) for i in (0, 1, 150, 299)]
        bytes_written = [dict(m.write_bytes) for m in c.metrics]
        return scan, got, bytes_written
    finally:
        c.destroy()


def test_both_clusters_give_equal_answers_and_bytes(tmp_path):
    port = _drive(Cluster, str(tmp_path / "torch"))
    ref = _drive(JaxCluster, str(tmp_path / "jax"))
    assert len(port[0]) == 300
    assert port[0] == ref[0]
    assert port[1] == ref[1] == [b"over", b"v1" * 2, b"over" * 1,
                                 b"v299" * (299 % 7 + 1)]
    assert port[2] == ref[2]
