"""The port's multi-process runtime on the CPU: `init_distributed` without a
world, the collective watchdog's two ends (a dead peer, a block past its
deadline), and the kernel library's first build when processes start at
once. Every process here is a new interpreter that imports no JAX."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu_torch.parallel.distributed import FAULT_EXIT, init_distributed  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_ENV_DROP = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "XLA_FLAGS", "JAX_PLATFORMS")


def _env() -> dict[str, str]:
    return {k: v for k, v in os.environ.items() if k not in _ENV_DROP}


def test_init_distributed_is_false_for_one_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_watchdog_exits_86_when_a_peer_dies(tmp_path):
    """Two gloo ranks; rank 1 dies after the first all_reduce; rank 0's next
    one, under the watchdog, ends with FAULT DETECTED and exit code 86
    (`dryrun --fault`), well before any deadline."""
    cmd = [sys.executable, "-m", "learn_fhe_tpu_torch.parallel.dryrun", "--ranks", "2", "--device", "cpu", "--fault", "--store", str(tmp_path)]
    r = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    assert "FAULT DETECTED: all_reduce after peer loss" in out, out
    assert f"ranks exited with [{FAULT_EXIT}, 42]" in out, out


def test_watchdog_exits_86_past_its_deadline():
    """A block that outlasts the watchdog's seconds ends the process with
    FAULT DETECTED and exit code 86."""
    code = textwrap.dedent(
        """
        import time
        from learn_fhe_tpu_torch.parallel.distributed import collective_watchdog
        with collective_watchdog(1, "a collective that never returns"):
            time.sleep(60)
        """
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert r.returncode == FAULT_EXIT, r.stdout + r.stderr
    assert "FAULT DETECTED: a collective that never returns did not complete within 1s" in r.stderr


_STUB_NVCC = """\
#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(1)
out = args[args.index("-o") + 1]
open(out, "w").write("built")
"""


def test_first_build_is_made_once_by_processes_that_start_together(tmp_path):
    """Two processes call `kernels.build_once` on the same library at once,
    with nvcc stubbed by a script that logs each call and takes a second:
    one compiles and links, the other waits on the lock and finds the
    library built."""
    log, nvcc = tmp_path / "nvcc.log", tmp_path / "nvcc"
    nvcc.write_text(_STUB_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    csrc, so = tmp_path / "csrc", tmp_path / "build" / "liblft_kernels-test.so"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// stub\n")
    code = textwrap.dedent(
        f"""
        from pathlib import Path
        from learn_fhe_tpu_torch.utils import kernels
        kernels._nvcc = lambda: {str(nvcc)!r}
        kernels.build_once(Path({str(csrc)!r}), Path({str(so)!r}), ("a.cu", "b.cu"))
        print(Path({str(so)!r}).read_text())
        """
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("built") for o in outs), outs
    assert sorted(log.read_text().split()) == ["compile", "compile", "link"]
    assert not list(so.parent.glob("*.tmp"))
