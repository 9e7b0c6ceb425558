"""Python interface to the native sweep executor.

Port of ``ppi_tpu/utils/sweep.py``. ``ppi-sweep`` (the shared
``native/sweep_runner.cpp``) runs one shell command a line of a spec file
over a bounded pool of worker processes, with per-job logs, retries, a
JSONL summary and a clean teardown on SIGINT. ``build_native`` compiles it
with the host's C++ compiler into the git-ignored ``build/native/``.
"""

import json
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "sweep_runner.cpp"
BINARY = ROOT / "build" / "native" / "ppi-sweep"


def build_native(force: bool = False) -> Path:
    """Compile the sweep executor if needed; returns the binary's path."""
    if BINARY.exists() and not force:
        return BINARY
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: ppi-sweep is built from "
                           f"{SOURCE}")
    BINARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = BINARY.with_suffix(f".{os.getpid()}")
    subprocess.run([cxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-o",
                    str(tmp), str(SOURCE)], check=True, capture_output=True)
    tmp.replace(BINARY)
    return BINARY


def run_sweep(commands, n_workers: int = 0, retries: int = 0,
              workdir: Path = None, logdir: Path = None):
    """Run shell commands through the native executor; returns (rows,
    exit code), a row per command with its id, cmd, exit, seconds and
    attempts, in command order."""
    binary = build_native()
    workdir = Path(workdir or ".")
    spec = workdir / "sweep_spec.txt"
    summary = workdir / "sweep_summary.jsonl"
    spec.write_text("\n".join(commands) + "\n")
    args = [str(binary), str(spec), "-o", str(summary)]
    if n_workers:
        args += ["-j", str(n_workers)]
    if retries:
        args += ["-r", str(retries)]
    if logdir:
        args += ["-l", str(logdir)]
    proc = subprocess.run(args)
    rows = [json.loads(line) for line in summary.read_text().splitlines()
            if line]
    rows.sort(key=lambda r: r["id"])
    return rows, proc.returncode
