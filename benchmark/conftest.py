"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker, for tests that need a CUDA card,
and the ``card`` fixture, which decides at run time whether there is one."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """A test that takes this fixture skips without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


SERVE = "duffing.serve-64k"


@pytest.fixture(scope="session")
def serve_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the serving cell
    (``traffic/serve-64k.json``, ``limits/duffing.serve-64k.json``), which
    the benchmark keeps out of its cells until its calls' latencies are
    steady enough to bound; the harness's ``serve`` entry is tested
    through it."""
    import json
    import os
    import shutil

    from benchmark import spec

    root = tmp_path_factory.mktemp("serve_root")
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(spec.ROOT, "artifacts"), root / "artifacts")
    bench = spec.load_benchmark(spec.ROOT)
    bench["workloads"].append({"name": SERVE, "config": "duffing",
                               "traffic": "serve-64k", "chips": 1,
                               "why": "the serving entry"})
    for name in ("call_ms_p50", "call_ms_p95"):
        bench["end_to_end"].append({"name": name, "unit": "ms",
                                    "better": "lower", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": [SERVE]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture
def root_of(serve_root):
    """The checkout a cell runs from: this one, or for the serving cell
    :func:`serve_root`."""
    from benchmark import spec

    return lambda cell: serve_root if cell == SERVE else spec.ROOT
