"""``chip_smoke.py``'s rendering phases alone on the card.

    python -m ppi_tpu_torch.studies.render_phases

Run from the repo root (it imports ``chip_smoke``): phase 41 (the
canonical ``make policy-search`` with ``--render --plot``), then a T=60
door-v0 episode at phase 4's config rendered through phase 49
(``render_phase``: the schematic GIF and AVI, the ray-caster at 320x240
with its ms a frame and peak memory, ``run_mpc --render --render-3d
--video-format avi``), then phase 50 (``run_opt --plot``, the figures,
the animations); each phase's seconds. The kernels build on first use.
"""

import subprocess
import tempfile
import time
from pathlib import Path


def main():
    import chip_smoke as cs
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.runners import run_mpc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t = time.perf_counter()
        cs.policy_search_phase(tmp / "ps")
        print(f"phase 41 s {time.perf_counter() - t}", flush=True)
        final = {}
        ret, success, track = run_mpc.main(
            run_mpc.build_parser().parse_args(cs.door_args(60)),
            lambda step, state, row: final.update(state=state))
        print(f"door-v0 T=60: return {ret}, success {success}", flush=True)
        t = time.perf_counter()
        cs.render_phase(Door(fixed_scene=True), track, final["state"],
                        tmp / "render")
        print(f"phase 49 s {time.perf_counter() - t}", flush=True)
        t = time.perf_counter()
        cs.figures_phase(tmp / "figures")
        print(f"phase 50 s {time.perf_counter() - t}", flush=True)


if __name__ == "__main__":
    main()
