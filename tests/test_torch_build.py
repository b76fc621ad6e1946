"""The lazy kernel build is thread-safe: threads that reach a kernel's
first use together (a serving engine's trainer and server) build it once.
``nvcc`` is replaced by a stub that sleeps, counts its runs and writes its
output, so this runs without a CUDA toolkit."""
import stat
import sys
import threading

from repro_torch.kernels import _build


def test_two_threads_build_once(tmp_path, monkeypatch):
    runs = tmp_path / "runs"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.5)\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'library')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")

    got, errors = [], []

    def worker():
        try:
            got.append(_build.build(("qo_merge",))["qo_merge"])
        except Exception as e:          # reported below, in the test thread
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert runs.read_text().splitlines() == ["run"]
    assert got == [_build.lib_path("qo_merge")] * 2
    assert got[0].read_bytes() == b"library"
    assert not list((tmp_path / "kernels").glob("*.tmp"))
