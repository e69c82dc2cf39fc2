"""Oracle cross-check batch.

    python tools/oracle_batch.py [res=64] [spp=128] [scene-stem ...]

Runs tools/oracle_compare.compare over the in-repo scene/mode list (or the
named scenes only) and appends one JSON line per result to
scenes_out/oracle_cross.jsonl so partial progress survives interruption;
rows already in the file are skipped.  Several processes with disjoint
scene lists may run at once.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.oracle_compare import compare  # noqa: E402

SCENES = Path(__file__).resolve().parent.parent / "scenes"

JOBS = [
    (SCENES / "cornell.txt", "mis"),
    (SCENES / "cornell.txt", "bsdf"),
    (SCENES / "cornell.txt", "direct"),
    (SCENES / "dielectric_test.txt", "bsdf"),
    (SCENES / "dielectric_test.txt", "mis"),
    (SCENES / "dielectric_test.txt", "direct"),
    (SCENES / "mis_test.txt", "mis"),
    (SCENES / "mis_test.txt", "bsdf"),
    (SCENES / "mis_test.txt", "direct"),
    (SCENES / "glassbunny.txt", "mis"),
    (SCENES / "glassbunny.txt", "bsdf"),
    # texture / normal-map / env pipeline rows: the oracle's own
    # bilinear/TBN/env ports (tools/oracle.py) vs the framework's
    # atlas/TBN/env path
    (SCENES / "texturecube.txt", "mis"),
    (SCENES / "normalmap_test.txt", "mis"),
    (SCENES / "envbunny.txt", "mis"),
    (SCENES / "textureenv.txt", "mis"),
]


def main():
    out_path = Path("scenes_out/oracle_cross.jsonl")
    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            try:
                d = json.loads(line)
                done.add((d["scene"], d["mode"]))
            except Exception:
                pass
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    only = set(sys.argv[3:])
    for scene, mode in JOBS:
        if only and scene.stem not in only:
            continue
        key = (scene.stem, mode)
        if key in done:
            print(f"skip {key} (done)", flush=True)
            continue
        t0 = time.time()
        print(f"running {scene.stem} {mode} ...", flush=True)
        # mis_test DIRECT is heavy-tailed (near-delta sphere-light spikes,
        # VERDICT r3 item 8): clamp both sides at the 99th percentile so
        # the row measures physics, not which spikes landed
        clamp = 99.0 if (scene.stem == "mis_test" and mode == "direct") else None
        try:
            out = compare(str(scene), mode, res=res, spp=spp, clamp_pct=clamp,
                          log=lambda *a: print(" ", *a, flush=True))
        except Exception as e:  # keep the batch alive
            out = {"scene": scene.stem, "mode": mode, "error": repr(e)}
        out["total_s"] = round(time.time() - t0, 1)
        with out_path.open("a") as f:
            f.write(json.dumps(out) + "\n")
        print(" ", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
