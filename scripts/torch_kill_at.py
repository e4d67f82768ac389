"""Run the port's trainer CLI and SIGKILL its own process at a fixed server
iteration: a crash test's deterministic stand-in for a power cut.

    python3 scripts/torch_kill_at.py ITERATION -- ARGS...

ARGS are `python -m kafka_ps_tpu_torch.cli.run`'s.  The wrapper patches
`ServerNode.maybe_checkpoint`, which runs after every server apply, so
that the process kills itself right after the first apply that brings
the server to ITERATION or past it (after the checkpoint that apply may
have been due).  A serial run is therefore cut at the same state every
time, with no close and no final save; what it applied past its last
commit point lives only in the durable log.  Run the same CLI command
again, without this wrapper, to restore and replay.
"""

from __future__ import annotations

import os
import signal
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    if len(argv) < 2 or argv[1] != "--":
        raise SystemExit(__doc__)
    at = int(argv[0])
    sys.path.insert(0, REPO)
    from kafka_ps_tpu_torch.cli import run
    from kafka_ps_tpu_torch.runtime.server import ServerNode

    apply_done = ServerNode.maybe_checkpoint

    def maybe_checkpoint(self):
        apply_done(self)
        if self.iterations >= at:
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    ServerNode.maybe_checkpoint = maybe_checkpoint
    return run.main(argv[2:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
