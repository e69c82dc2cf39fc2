"""High-spp oracle convergence runs (VERDICT r2 item 1).

Cross-RMSE between two unbiased, independently-implemented renderers is
bounded below by the quadrature of their MC noise floors; a systematic
physics divergence would NOT shrink with spp.  So the strongest
checkable accuracy statement is: cross-RMSE ≈ floor at every spp, and
both shrink as 1/sqrt(spp).  This batch adds the high-spp points.

Runs sequentially, appending to scenes_out/oracle_cross.jsonl with an
"spp" field distinguishing the rows.
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

# (scene, mode, res, spp) — 2000 spp on the analytic scenes (the
# BASELINE.json operating point), 512 on the mesh scene (oracle cost)
JOBS = [
    (SCENES / "cornell.txt", "mis", 64, 2000),
    (SCENES / "cornell.txt", "bsdf", 64, 2000),
    (SCENES / "dielectric_test.txt", "mis", 64, 2000),
    (SCENES / "mis_test.txt", "mis", 64, 2000),
    (SCENES / "glassbunny.txt", "mis", 64, 512),
]


def main():
    out_path = Path("scenes_out/oracle_cross.jsonl")
    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            try:
                d = json.loads(line)
                done.add((d["scene"], d["mode"], d.get("spp")))
            except Exception:
                pass
    for scene, mode, res, spp in JOBS:
        key = (scene.stem, mode, spp)
        if key in done:
            print(f"skip {key} (done)", flush=True)
            continue
        t0 = time.time()
        print(f"running {scene.stem} {mode} @{spp}spp ...", flush=True)
        try:
            out = compare(str(scene), mode, res=res, spp=spp,
                          log=lambda *a: print(" ", *a, flush=True))
        except Exception as e:
            out = {"scene": scene.stem, "mode": mode, "spp": spp,
                   "error": repr(e)}
        out["total_s"] = round(time.time() - t0, 1)
        with out_path.open("a") as f:
            f.write(json.dumps(out) + "\n")
        print(" ", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
