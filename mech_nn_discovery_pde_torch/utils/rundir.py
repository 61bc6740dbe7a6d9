"""Run directories + source provenance (copy of the JAX package's
utils/rundir.py).

create_log_dir picks the first free integer directory under the experiment
root; write_source_files snapshots `git diff` of the Python files and the
commit hash of the checkout that holds this package into the run dir.  Where
that tree is not a git checkout (a copy of the files), or git is missing,
the two files hold git's error message instead and the run goes on."""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Tuple

_log_dir: Optional[str] = None
_run_id: Optional[int] = None

# the directory that holds the package: git runs there, and never searches
# above it for another repository
_TREE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def create_log_dir(root: str = "logs/misc", reuse: bool = True) -> Tuple[str, int]:
    global _log_dir, _run_id
    if reuse and _log_dir is not None:
        return _log_dir, _run_id
    for i in range(100000):
        path = os.path.join(root, str(i))
        if not os.path.isdir(path):
            os.makedirs(path)
            _log_dir, _run_id = path, i
            return path, i
    raise RuntimeError("run-dir limit exceeded")


def _git_to_file(args, path: str) -> None:
    env = dict(os.environ, GIT_CEILING_DIRECTORIES=os.path.dirname(_TREE))
    with open(path, "w") as fd:
        try:
            subprocess.run(["git", *args], cwd=_TREE, env=env, stdout=fd, stderr=fd,
                           timeout=60, check=False)
        except (OSError, subprocess.TimeoutExpired) as e:
            fd.write(f"git {' '.join(args)} did not run: {e}\n")


def write_source_files(run_dir: str) -> None:
    os.makedirs(run_dir, exist_ok=True)
    diff = os.path.join(run_dir, "git.diff")
    if not os.path.isfile(diff):
        _git_to_file(["diff", "--", "*.py"], diff)
    commit = os.path.join(run_dir, "commit.txt")
    if not os.path.isfile(commit):
        _git_to_file(["rev-parse", "HEAD"], commit)
