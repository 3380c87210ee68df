"""Run a test module in a fresh interpreter (shared isolation helper).

XLA:CPU segfaults compiling certain Pallas/while-loop-heavy executables
ONLY in a long-lived full-suite process (two distinct crash sites
observed: serializing an executable for the persistent cache, and —
with cache writes disabled — inside backend_compile_and_load itself;
the same modules pass every time in a fresh process).  Whatever
cumulative LLVM/XLA process state triggers it, a subprocess gives the
module the exact solo configuration that is known good, and bounds the
blast radius to one failed wrapper test instead of a suite-killing
SIGSEGV (CLAUDE.md, GPU discipline item 3).

Modules isolated this way are named _<name>_impl.py (underscore = not
collected by the parent run) and invoked by a thin test_<name>.py
wrapper calling run_isolated().
"""
import os
import subprocess
import sys


def run_isolated(impl_basename: str) -> None:
    """pytest the given tests/<impl_basename> in a subprocess; assert rc=0."""
    here = os.path.dirname(os.path.abspath(__file__))
    impl = os.path.join(here, impl_basename)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", impl, "-q", "--no-header"],
        capture_output=True, text=True, cwd=os.path.dirname(here))
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout[-8000:])
        sys.stderr.write(proc.stderr[-4000:])
    assert proc.returncode == 0, \
        f"{impl_basename} subprocess suite failed (rc={proc.returncode})"
