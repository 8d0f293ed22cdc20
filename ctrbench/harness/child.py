"""Child processes of a run (the load generator, the replicas of a fan-out
cell): a fresh interpreter started with subprocess, joined to its parent by
one socket pair that carries pickled messages. multiprocessing's own spawn
would also start a resource tracker process, which outlives the run by a
moment; this starts nothing but the child.

    python -m ctrbench.harness.child <fd>

reads (module, function, args) from the socket and calls
function(connection, *args).
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
from multiprocessing.connection import Connection
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Child:
    """A started child: the parts of multiprocessing.Process the runner uses."""

    def __init__(self, popen: subprocess.Popen, name: str):
        self.popen = popen
        self.name = name

    @property
    def exitcode(self):
        return self.popen.poll()

    def is_alive(self) -> bool:
        return self.popen.poll() is None

    def join(self, timeout: float | None = None) -> None:
        try:
            self.popen.wait(timeout)
        except subprocess.TimeoutExpired:
            pass

    def terminate(self) -> None:
        if self.is_alive():
            self.popen.terminate()


def start(module: str, function: str, args: tuple, name: str) -> tuple[Child, Connection]:
    """Run module.function(conn, *args) in a new interpreter."""
    ours, theirs = socket.socketpair()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    popen = subprocess.Popen([sys.executable, "-m", "ctrbench.harness.child",
                              str(theirs.fileno())], pass_fds=(theirs.fileno(),),
                             cwd=str(ROOT), env=env)
    theirs.close()
    conn = Connection(ours.detach())
    conn.send((module, function, args))
    return Child(popen, name), conn


def _main() -> None:
    conn = Connection(int(sys.argv[1]))
    module, function, args = conn.recv()
    target = getattr(importlib.import_module(module), function)
    try:
        target(conn, *args)
    finally:
        conn.close()


if __name__ == "__main__":
    _main()
