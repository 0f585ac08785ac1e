"""Preemption handling for the training loops (port of
`ideal_gan_tpu/utils/preempt.py`).

`PreemptionGuard` turns SIGTERM/SIGINT into a graceful stop: the handler
only latches `should_stop`; the trainer checks it after each epoch, saves a
checkpoint (synchronously: `utils.Checkpoint.save` writes and closes the
file before it returns) and exits 0. The next invocation resumes from that
checkpoint.

    guard = PreemptionGuard()
    for ep in range(start, epochs):
        ...train one epoch...
        if guard.should_stop:
            ckpt.save(ep + 1, state.state_dict())
            print(f"preempted: checkpointed epoch {ep + 1}, exiting")
            break
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a should_stop flag (single-shot: the
    handler restores the previous one, so a second signal kills a stuck
    run). Off the main thread, where handlers cannot be installed, it is a
    no-op guard."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._previous = {}
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                # not the main thread: degrade to a no-op guard
                pass

    def _handler(self, signum, frame):
        self.should_stop = True
        prev = self._previous.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):
            pass

    def restore(self) -> None:
        """Reinstall the handlers that were there before the guard."""
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
