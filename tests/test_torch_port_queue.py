"""The port's test files queue behind `tests/test_cli.py` under `--dist loadfile`.

The tier-1 run (`pytest -n 6 --dist loadfile`) gives each worker whole files.
xdist's loadfile scheduler (`xdist/scheduler/loadscope.py`) queues the files
by their number of collected items, largest first, and hands each worker two
of them before it hands out any more. `tests/test_cli.py` is the file that
sets the run's wall time, so it must leave in that first round: no port test
file may hold as many items as it does. The card-only
`tests/test_torch_port_cuda.py` is the one exception, since its cases skip
here in no time.
"""
import collections
import fnmatch
import os

import pytest

CLI = "tests/test_cli.py"
EXEMPT = {"tests/test_torch_port_cuda.py"}


def test_port_files_hold_fewer_items_than_test_cli(request):
    """Counts the items of every collected file, as the scheduler does (every
    xdist worker collects the whole suite); skips when `test_cli.py` is not
    collected, as when one file runs alone."""
    counts = collections.Counter(item.nodeid.split("::", 1)[0]
                                 for item in request.session.items)
    if CLI not in counts:
        pytest.skip(f"{CLI} is not collected in this run")
    ahead = {path: n for path, n in counts.items()
             if fnmatch.fnmatch(os.path.basename(path), "test_torch_*.py")
             and path not in EXEMPT and n >= counts[CLI]}
    assert not ahead, (f"port test files with at least the {counts[CLI]} items of {CLI}, "
                       f"which would start before it: {ahead}")
