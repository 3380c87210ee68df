"""Run the five BASELINE gate configs at FULL scale on the live backend.

One JSON line per gate, with wall-clock seconds; everything runs at
scale=1.0 unless GATE_SCALE says otherwise.

Usage (one process per GPU: a JAX process reserves most of the card):
  python scripts/run_gates.py [gate ...]
Env: GATE_SCALE=1.0 to override, GATE_FRAMES to cap frames.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from voxelray_tpu.utils.gates import GATE_RUNNERS, run_gate

    names = sys.argv[1:] or list(GATE_RUNNERS)
    scale = float(os.environ.get("GATE_SCALE", "1.0"))
    frames = os.environ.get("GATE_FRAMES")
    import jax
    print(f"backend={jax.default_backend()}", file=sys.stderr, flush=True)
    for name in names:
        kw = {}
        if frames and name in ("knot512", "deform8"):
            kw["frames"] = int(frames)
        t0 = time.perf_counter()
        out = run_gate(name, scale=scale, **kw)
        secs = round(time.perf_counter() - t0, 1)
        out = {"gate": name, "scale": scale, "secs": secs, **out}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
