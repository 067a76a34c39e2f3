"""The main loop the A/B tools share. ``python3 tools/<tool>.py TREE [TREE
...]`` prints the card's name and power limit, then measures each checkout
in turn, each in a process of its own (``<tool>.py --one TREE``), which
prints one JSON line. With no argument it prints the tool's usage."""
from __future__ import annotations

import json
import subprocess
import sys


def run(argv, one, script: str, usage: str) -> int:
    """``one(tree) -> dict`` measures the checkout at ``tree``; ``script``
    is the tool's own path."""
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in argv:
        rc = subprocess.run([sys.executable, script, "--one",
                             tree]).returncode
        if rc:
            return rc
    return 0
