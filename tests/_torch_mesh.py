"""Launcher of the port's mesh-parallel tests: starts the Gloo ranks of
``tests/_torch_mesh_worker.py`` once per test file, hands them their
inputs and collects their results.  The ranks start (importing torch)
while the test computes its inputs and the JAX references."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(suite: str, world: int, workdir) -> list:
    """Start ``world`` ranks of ``suite``; they wait for ``write_inputs``."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_mesh_worker.py"),
                              suite, str(r), str(world), str(port), str(workdir)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)]


def write_inputs(workdir, inputs: dict) -> None:
    """Write the ranks' inputs atomically (a temporary name, then rename)."""
    tmp = os.path.join(str(workdir), "inputs.pt.tmp")
    torch.save(inputs, tmp)
    os.replace(tmp, os.path.join(str(workdir), "inputs.pt"))


def collect(procs: list, workdir, timeout: float = 400.0) -> list:
    """Every rank's result dict (in rank order); a rank that failed raises
    with its output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results, failures = [], []
    for r, (p, text) in enumerate(zip(procs, outs)):
        path = os.path.join(str(workdir), f"rank{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        if p.returncode != 0 or "error" in res:
            failures.append(f"rank {r} failed (rc {p.returncode}):\n{res.get('error', '')}\n"
                            f"{text[-3000:]}")
        results.append(res)
    if failures:
        raise AssertionError("\n".join(failures))
    return results
