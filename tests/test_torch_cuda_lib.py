"""ops/cuda_lib.py's background builds, on the CPU with a stub compiler (a
script standing in for nvcc that sleeps, counts its runs and writes the
library, or fails on a source that asks it to): `prefetch` returns before
the compile ends, `build` waits for it and compiles nothing twice, a failed
background build raises at `load` with the compiler's stderr, and a scene
built on the CPU starts no build."""
import stat
import sys
import threading
import time

import pytest
import torch

from raytrace_tpu_torch.ops import cuda_lib
from raytrace_tpu_torch.scene import presets
from raytrace_tpu_torch.scene.builder import SceneBuilder

STUB = f"""#!{sys.executable}
import os, sys, time
args = sys.argv[1:]
src, out = args[-1], args[args.index("-o") + 1]
with open(os.environ["STUB_COUNT"], "a") as f:
    f.write(src + "\\n")
time.sleep(float(os.environ.get("STUB_SLEEP", "0")))
if "error" in open(src).read():
    sys.stderr.write("stub: error in " + src + "\\n")
    sys.exit(1)
open(out, "w").write("library")
"""


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """cuda_lib with its sources, build directory and nvcc in tmp_path →
    a function that reads how many compiles have run."""
    compiler = tmp_path / "nvcc"
    compiler.write_text(STUB)
    compiler.chmod(compiler.stat().st_mode | stat.S_IXUSR)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "good.cu").write_text("// a kernel\n")
    (tmp_path / "src" / "bad.cu").write_text("// an error\n")
    count = tmp_path / "count"
    count.write_text("")
    monkeypatch.setenv("STUB_COUNT", str(count))
    monkeypatch.setenv("STUB_SLEEP", "1.5")
    monkeypatch.setattr(cuda_lib, "SRC_DIR", tmp_path / "src")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "nvcc_path", lambda: str(compiler))
    monkeypatch.setattr(cuda_lib, "_pending", {})
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    return lambda: len(count.read_text().splitlines())


def test_prefetch_returns_before_the_compile_ends(stub):
    t = time.perf_counter()
    cuda_lib.prefetch("good")
    assert time.perf_counter() - t < 1.0
    assert not list(cuda_lib.BUILD_DIR.glob("libgood_*.so"))
    path = cuda_lib.build("good")
    assert time.perf_counter() - t >= 1.5
    assert path.read_text() == "library"
    assert stub() == 1


def test_build_waits_and_compiles_once(stub):
    cuda_lib.prefetch("good")
    cuda_lib.prefetch("good")  # pending: starts nothing
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        cuda_lib.build("good"))) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert len(results) == 2 and results[0] == results[1]
    assert results[0].exists()
    assert stub() == 1
    # a library that exists is only hashed: no build starts
    cuda_lib._pending.clear()
    cuda_lib.prefetch("good")
    assert not cuda_lib._pending
    assert cuda_lib.build("good") == results[0]
    assert stub() == 1


def test_failed_background_build_raises_at_load(stub, monkeypatch):
    monkeypatch.setenv("STUB_SLEEP", "0")
    cuda_lib.prefetch("bad")
    for _ in range(2):  # and again at every later call
        with pytest.raises(RuntimeError, match="stub: error in .*bad.cu"):
            cuda_lib.load("bad", {})
    assert stub() == 1
    assert not list(cuda_lib.BUILD_DIR.glob("*.so"))


@pytest.mark.parametrize("device,started", [("cpu", []),
                                            ("cuda", ["threefry"])])
def test_scene_build_prefetches_only_on_a_card(monkeypatch, device,
                                               started):
    """A CUDA scene starts the draws' kernel first, before any tensor is
    made (here, without a card, the first one then fails); a CPU scene,
    with its BVH and clusters, starts no build."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: this checks the order without one")
    calls = []
    monkeypatch.setattr(cuda_lib, "prefetch", lambda *n: calls.extend(n))
    verts, idx = presets.terrain_mesh(1024, 0)
    sb = SceneBuilder()
    sb.triangle_mesh(verts, idx, material=sb.matte((0.5, 0.5, 0.5)))
    sb.point_light((0.0, 0.0, 14.0), (500.0, 500.0, 500.0))
    if device == "cpu":
        assert sb.build(device).bvh is not None
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            sb.build(device)
    assert calls == started
