"""Run a Python script as `__main__` while a thread samples the main
thread's stack, to see where a long script such as `chip_smoke.py` spends
its wall time (waits on the card and on subprocesses included, which a
CPU profiler misses).

    python -m ideal_gan_tpu_torch.cli.sample_stacks \\
        --out chiprun_out/stacks.json chip_smoke.py

Every `--interval` seconds it takes the main thread's stack and keeps the
frames of the script's own file, outermost first, less the first
`--skip` (for `chip_smoke.py`, its module and `main`). It writes one
JSON object: the interval; `inclusive`, the samples of each chain of up
to `--depth` of those frames (its first frame alone, then with the
next, ...); and `leaf`, the samples of each (first frame, innermost
frame of any file). Samples × interval ≈ seconds. The script's exit code
is passed on.
"""

from __future__ import annotations

import argparse
import collections
import json
import runpy
import sys
import threading
from pathlib import Path


def sample_stacks(script: str, argv: list, interval: float = 0.25,
                  skip: int = 2, depth: int = 4) -> tuple[dict, int]:
    """Run `script` with `argv` as `__main__`, sampling its stack (module
    docstring): (the counts, its exit code)."""
    inclusive, leaf = collections.Counter(), collections.Counter()
    main_id = threading.current_thread().ident
    name = Path(script).name
    done = threading.Event()

    def sample():
        while not done.wait(interval):
            f = sys._current_frames().get(main_id)
            if f is None:
                continue
            inner = f"{Path(f.f_code.co_filename).name}:{f.f_code.co_name}"
            chain = []
            while f is not None:
                if Path(f.f_code.co_filename).name == name:
                    chain.append(f.f_code.co_name)
                f = f.f_back
            chain = chain[::-1][skip:]
            for d in range(1, min(len(chain), depth) + 1):
                inclusive[" > ".join(chain[:d])] += 1
            if chain:
                leaf[f"{chain[0]} | {inner}"] += 1

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    saved, sys.argv = sys.argv, [script, *argv]
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        sys.argv = saved
        done.set()
        thread.join()
    return dict(interval=interval, inclusive=inclusive.most_common(),
                leaf=leaf.most_common()), code


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="JSON file to write")
    p.add_argument("--interval", type=float, default=0.25)
    p.add_argument("--skip", type=int, default=2)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    counts, code = sample_stacks(a.script, a.args, a.interval, a.skip,
                                 a.depth)
    Path(a.out).write_text(json.dumps(counts, indent=0))
    return code


if __name__ == "__main__":
    sys.exit(main())
