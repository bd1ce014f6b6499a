# Port of analytics_zoo_tpu/core/launcher.py, its serving half: the child
# command is this package's server module (-m analytics_zoo_tpu_torch.
# serving.server).  The gang training launcher is not ported yet.
"""Process launching: ``zoo-serving`` replicas as child processes.

The serving half of the JAX package's ``zoo-launch`` module, which the
``ServingController``'s subprocess scale-up (``SubprocessReplicaFactory``,
``zoo-serving --autoscale``) uses: :func:`launch_serving_replica` spawns
one ``python -m analytics_zoo_tpu_torch.serving.server`` child on a free
port, :func:`wait_serving_ready` polls until it accepts connections (the
child loads and warms its model before binding), and
:func:`_terminate_gang` stops children (SIGTERM, then SIGKILL after a
grace period).

The gang training launcher of the JAX package (``launch``, its supervisor
and ``main``, over ``jax.distributed``) needs ``torch.distributed`` and
the port's ``core/context.py``: they raise ``NotImplementedError`` until
then (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")

SERVER_MODULE = "analytics_zoo_tpu_torch.serving.server"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _terminate_gang(procs: List[subprocess.Popen], grace: float) -> None:
    """SIGTERM every live child, give them ``grace`` seconds to exit, then
    SIGKILL stragglers and reap."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
            p.wait()


def launch_serving_replica(extra_args: List[str],
                           host: str = "127.0.0.1",
                           port: Optional[int] = None,
                           env: Optional[Dict[str, str]] = None,
                           ) -> Tuple[subprocess.Popen, int]:
    """Spawn ONE ``zoo-serving`` child of this package on this machine.
    ``extra_args`` is the model/config tail of the child's command line
    (``--model-dir ...`` etc.); host/port are prepended here so the
    caller controls the address.  Returns ``(proc, port)``; pair with
    :func:`wait_serving_ready` before routing traffic at it."""
    if port is None:
        port = _free_port()
    cmd = [sys.executable, "-m", SERVER_MODULE,
           "--host", host, "--port", str(port)] + list(extra_args)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    proc = subprocess.Popen(cmd, env=child_env)
    logger.info("launched serving replica pid=%d on %s:%d", proc.pid,
                host, port)
    return proc, port


def wait_serving_ready(host: str, port: int,
                       proc: Optional[subprocess.Popen] = None,
                       timeout: float = 60.0,
                       interval: float = 0.1) -> bool:
    """Poll until the replica accepts TCP connections (the server loads,
    and so warms, its model before binding).  Returns False early when
    ``proc`` already exited."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            time.sleep(interval)
    return False


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (the gang training launcher) is not ported yet (ROADMAP "
        "Queue 1 item 7: it needs torch.distributed and core/context.py); "
        "launch_serving_replica starts serving children")


def launch(*args: Any, **kwargs: Any) -> int:
    """The JAX package's gang launcher and supervisor: not ported yet."""
    raise _not_ported("core.launcher.launch")


def main(argv: Optional[List[str]] = None) -> int:
    """The JAX package's ``zoo-launch`` command: not ported yet."""
    raise _not_ported("zoo-launch (core.launcher.main)")
