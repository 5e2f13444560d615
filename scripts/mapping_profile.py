"""Stage + host-function profile of a full mapping bench run.

Times the three init phases (synthesize, DatabaseCache.create, pipeline
run) separately and prints the pipeline's internal stage timers plus the
top host-side functions by cumulative time (cProfile), so init/register
host costs are attributable line-by-line.

    python scripts/mapping_profile.py [--images 200] [--cprofile]
"""

import argparse
import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("COLMAP_TPU_PROFILE", "1")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--cprofile", action="store_true")
    args = p.parse_args()

    from colmap_tpu.controllers.incremental_pipeline import IncrementalPipeline
    from colmap_tpu.scene.database import Database
    from colmap_tpu.scene.database_cache import DatabaseCache
    from colmap_tpu.scene.synthetic import (SyntheticDatasetOptions,
                                            synthesize_dataset)

    t0 = time.perf_counter()
    db = Database(":memory:")
    synthesize_dataset(
        SyntheticDatasetOptions(num_images=args.images,
                                num_points3D=10 * args.images,
                                point2D_stddev=0.5, seed=3), db)
    t_synth = time.perf_counter() - t0

    pipe = IncrementalPipeline(db)

    t0 = time.perf_counter()
    cache = DatabaseCache.create(db,
                                 min_num_matches=pipe.options.min_num_matches)
    t_cache = time.perf_counter() - t0

    prof = cProfile.Profile() if args.cprofile else None
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    rec = pipe.run(cache=cache)
    if prof:
        prof.disable()
    t_run = time.perf_counter() - t0

    n_reg = 0 if rec is None else rec.num_registered_images()
    stage_total = sum(pipe.stage_s.values())
    print(f"synth={t_synth:.1f}s cache={t_cache:.1f}s run={t_run:.1f}s "
          f"registered={n_reg} img/s(run-only)={n_reg / t_run:.2f} "
          f"img/s(bench={n_reg}/{t_cache + t_run:.0f}s)="
          f"{n_reg / (t_cache + t_run):.2f}")
    print(f"stage timers ({stage_total:.1f}s of {t_run:.1f}s run; "
          f"untimed={t_run - stage_total:.1f}s):")
    for k, v in sorted(pipe.stage_s.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {v:8.1f}s")
    if prof:
        st = pstats.Stats(prof)
        st.sort_stats("cumulative")
        st.print_stats(35)


if __name__ == "__main__":
    main()
