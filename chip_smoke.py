"""Smoke run of the torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one line each (phase 6 one per case); any failure exits non-zero:
  1. build   -- generate the door-v0 body and build both kernels with nvcc
                for sm_90a, in parallel; print the rollout kernel's build
                time and -Xptxas -v summary;
  2. check   -- the kernel against its plain version (the eager rollout) on
                the card at N=1000 (ragged), H=20: final state and rewards,
                a pre-poisoned NaN lane, the horizon mask in the objective,
                and a sampled door frame;
  3. timings -- kernel time (CUDA events) at N=1024/H=160, N=64/H=30 and
                N=1024/H=20, the plain rollout at N=1024/H=20, ms per PPI
                iteration at N=1024/H=160 (sample -> kernel -> LBPS
                update);
  4. episode -- the canonical door-v0 episode through the port's runner
                (Lbps, SE kernel, delta 0.9, 2 iters, anneal 0.5,
                lengthscale 0.08, 64 samples, H=30, T=250, 50 warm-start
                iterations, seed 0): finite return, exactly 800 kernel
                launches of door-v0's routed layout (the split layout,
                phases 35-37; each real step is one), the door open;
  5. build   -- the moment-match kernels' build time, -Xptxas -v summary
                of each (prologue, main at tiles 128 and 64, epilogue) and
                the HGMMA (wgmma, tensor-core) instructions in their SASS;
  6. check   -- the moment-match kernel against its plain version and both
                against a float64 oracle on the card: (4096, 64) with
                heavy-tailed weights and 0-3 quarters masked, (4000, 640),
                (1000, 17), (256, 9) with a mean offset of 100, and every
                lane but one at -inf (ESS 1); sigma exactly symmetric; two
                launches bit-identical;
  7. timings -- the kernel, the single-pass plain version and the two-pass
                m_projection (CUDA events) at (100, 20), (4096, 64),
                (4096, 640) and (16384, 640); at (4096, 640) the kernel and
                ``torch.cov`` in turns (kernel, cov, cov, kernel) and each
                of the wrapper's three launches' device time
                (``torch.profiler``); both bounds (the f32 SIMT one and the
                tensor cores' for three TF32 products); ms per
                optimization iteration at d=640, N=4096 (sample,
                NoisySphere, Reps, Gaussian update);
  8. runs    -- three black-box runs through the port's run_opt (Reps,
                NoisySphere, 50 iterations, seed 0): d=640 and d=64 at
                N=4096 (exactly 50 kernel launches each), and the canonical
                d=20, N=100 (below the dispatch threshold: 0 launches);
  9. build   -- generate the pen-v0, relocate-v0 and cheetah bodies of the
                rollout kernel's lane layout (reward constants, action
                reward) and build them with nvcc in parallel with phases 1
                and 5; print each body's line count, nvcc seconds and
                -Xptxas -v summary (relocate-v0, cheetah and pen-v0 route
                to their split bodies, phases 35-37, which phases 10-12
                run);
 10. check   -- each body against the plain version on the card at N=1000
                (ragged), H=10: rewards and final state, a pre-poisoned NaN
                lane, the horizon mask and two goals (pen-v0, relocate-v0)
                over the first 5 steps, actions past the torque box
                (cheetah), and the real step through the kernel (N=1, H=1)
                against the eager step;
 11. timings -- each body's kernel time (CUDA events) at its canonical
                shape and, with the plain rollout's, at its N and H_PLAIN
                (pen-v0 N=96/H=15, relocate-v0 N=256/H=20, cheetah
                N=256/H=30; pen-v0 also at
                N=1024/H=160), one synced PPI iteration at each canonical
                shape and one real env step of each env through the kernel
                and one eager;
 12. episodes -- four MPC episodes through the port's run_mpc (seed 0, 50
                warm-start iterations): pen-v0 (Lbps, SE, T=100, H=15,
                N=96) and relocate-v0 (Mppi, ColouredNoise, T=140, H=20,
                N=256) to success, cheetah (Mppi, ColouredNoise, T=150,
                N=256) to a positive return, and make mpc-cem's door-v0
                (Cem, WhiteNoiseIid, N=64, T=100); exactly 350, 330, 350
                and 250 kernel launches of each env's routed layout (warm
                start + iterations + real steps);
 13. build   -- generate the door-v0-hand (12 DoF) and door-v0-adroit (23
                DoF) bodies (variants c and d: the bolt projection) and
                build them with nvcc in parallel with phases 1, 5 and 9;
                print each body's line count, nvcc seconds and -Xptxas -v
                summary. Both plan and step through the warp layout
                (phase 32's builds) in phases 14-16;
 14. check   -- each body against its plain version on the card at N=1000
                (ragged), H=10 (door-v0-adroit H=3: its plain rollout is
                ~200k eager launches a step): rewards and final state from
                a sampled frame, with lanes where the bolt clamp holds the
                door and lanes where the latch is pressed and it does not
                (both sets must be non-empty), a pre-poisoned NaN lane,
                the horizon mask in the objective and a second sampled
                frame (H=5; door-v0-adroit H=2, as the other Adroit-class
                bodies), and the real step through the kernel (N=1,
                H=1) against the eager step;
 15. timings -- each body's kernel time at N=64 and N=1024, H=30
                (door-v0-adroit H=10), the plain rollout and the kernel at
                N=64/H=H_PLAIN (door-v0-adroit H=1, as the other Adroit-class
                bodies), one synced PPI iteration at the canonical shape
                (H=30), one real step through the kernel, one eager real
                step and one observation;
 16. episodes -- the canonical config (Lbps, SE, delta 0.9, 2 iters, anneal
                0.5, lengthscale 0.08 = "4dt", N=64, H=30, T=250, 50
                warm-start iterations) on door-v0-hand at seeds 0-1 (door
                open at >= 1) and door-v0-adroit at seed 0: finite returns,
                exactly 800 kernel launches at seed 0 (50 + 250 x 2
                iterations + 250 real steps);
 17. build   -- generate the hammer-v0 (5 DoF), pen-v0-hand (11),
                relocate-v0-hand (13) and hammer-v0-hand (10) bodies and
                build them with nvcc beside all the others; print each
                body's line count, nvcc seconds and -Xptxas -v summary.
                relocate-v0-hand and hammer-v0-hand plan and step through
                the warp layout (phase 32's builds), pen-v0-hand through
                the split layout partitioned by the body tree (phase 35's
                build) in phases 18-20;
 18. check   -- each of those bodies against its plain version on the card
                at N=1000 (ragged), H=5: rewards
                and final state bit-identical or within 1e-6, from lanes in
                which the object is in contact (the nail under the head, the
                hammer dropped on the nail, the digits on the pen and over
                the ball; the lanes where it moved are counted and must not
                be none), a pre-poisoned NaN lane, the horizon mask in the
                objective and a second board or goal (H=3; relocate-v0-hand
                H=5), and the real step through the kernel (N=1, H=1)
                against the eager step;
 19. timings -- each body's kernel time at its canonical shape and, with
                the plain rollout's, at its N and H_PLAIN (hammer-v0
                N=64/H=30, pen-v0-hand N=96/H=15,
                relocate-v0-hand N=256/H=20, hammer-v0-hand N=128/H=30),
                ops per lane step and the bound, one synced PPI iteration
                with the canonical solver and prior, one real step through
                the kernel, one eager real step and one observation;
 20. episodes -- make mpc-essps (Essps, hammer-v0, RffFeatures, 10 elites,
                lengthscale 0.15, N=64, H=30, T=250) at seeds 0-2: exactly
                550 launches each, the nail seated at >= 2; pen-v0-hand
                (Lbps, SE, T=100, H=15, N=96) and relocate-v0-hand (Mppi,
                ColouredNoise, T=140, H=20, N=256) at seed 0 to success with
                exactly 350 and 330 launches; hammer-v0-hand (Lbps, SE,
                T=50, H=30, N=128) at seed 0 with exactly 200 launches
                and a finite return (nail depth, lifted and success
                printed, success not required); and one T=20 door-v0
                episode with each prior no other phase runs (Lbps; 90
                launches, finite return);
 21. build   -- generate the reacher, finger~spin, fetch-push, fetch-pick,
                hopper, walker2d, walker~walk and humanoid-standup bodies
                (variant b) and build them with nvcc beside all the others;
                print each body's line count, nvcc seconds and -Xptxas -v
                summary. fetch-pick plans and steps through the warp
                layout (phase 32's build), walker2d, walker~walk and
                humanoid-standup through the split layout partitioned by
                the body tree, fetch-push, hopper, reacher and finger~spin
                through it with their heaviest chain of bodies cut into
                segments (phase 35's builds) in phases 22-24;
 22. check   -- each of those bodies against its plain version on the card
                at N=1000 (ragged), H=10: rewards and final state
                bit-identical or within TOL, from lanes in contact (the
                fingertip on the paddle, the paddle against the box, a
                fingertip against the ball; the lanes where the object
                moved, or that end with a foot on the ground, are counted
                and must not be none), a pre-poisoned NaN lane, the horizon
                mask in the objective, a second target or goal (reacher,
                fetch-push, fetch-pick; H=5), actions past the torque or
                action box, and the real step through the kernel (N=1,
                H=1) against the eager step;
 23. timings -- each body's kernel time at its canonical shape and, with
                the plain rollout's, at its N and H_PLAIN, ops per lane
                step and the bound, one synced PPI
                iteration with the canonical solver and prior, one real
                step through the kernel and one observation;
 24. episodes -- the eight envs through the port's run_mpc at the JAX
                repo's configs (Mppi; seed 0 unless stated; 50
                warm-start iterations) with exact launch counts (warm start
                + T iterations + T real steps) and a gate each: reacher's
                fingertip within 0.08 of the target at >= 3 of seeds 0-9,
                finger~spin >= 0.5 a step, fetch-push success at >= 3 of
                seeds 0-4, fetch-pick success at >= 2 of 3,
                hopper and walker2d a finite return above 0, walker~walk
                >= 0.3 a step, humanoid-standup a finite return above 110
                (what lying still earns);
 25. build   -- generate the pen-v0-adroit (20 DoF), relocate-v0-adroit
                (24) and hammer-v0-adroit (25) bodies and build them with
                nvcc first of all twenty-two builds (with phase 32's
                eight); print each body's line count, nvcc seconds and
                -Xptxas -v summary. All three plan and step through the
                warp layout in phases 26-28;
 26. check   -- each of those bodies against its plain version on the card
                at N=1000 (ragged), H=2 (the plain version is 191k-465k
                eager ops a lane step): rewards and final state
                bit-identical or within 1e-6, from lanes in contact (the pen
                on the fingers, the ball under the digits, the hammer
                dropped on the nail; the lanes where the object moved are
                counted and must not be none), a pre-poisoned NaN lane, the
                horizon mask in the objective (H=2) and a second goal or
                board (H=1), and the real step through the kernel (N=1,
                H=1) against the eager step;
 27. timings -- each body's kernel time at its canonical shape
                (pen-v0-adroit N=96/H=15, relocate-v0-adroit N=256/H=20,
                hammer-v0-adroit N=128/H=30) and at N=64/H=1, the plain
                rollout at N=64/H=1, ops per lane step and the bound, one
                synced PPI iteration with the canonical solver and prior,
                one real step through the kernel and one observation;
 28. episodes -- the canonical configs (``goal_success.py:78-92``) at seed
                0: pen-v0-adroit (Lbps, SE, T=100, H=15, N=96) and
                relocate-v0-adroit (Mppi, ColouredNoise, T=140, H=20,
                N=256) to success with exactly 350 and 330 launches,
                hammer-v0-adroit (Lbps, SE, T=50, H=30, N=128) with
                exactly 200 launches and a finite return (nail depth,
                lifted and success printed, success not required: the JAX
                package's rate is 0).
 29. check   -- the sharded entry (``sharded_pallas_mpc_objective``): one
                spawned group of 4 ranks sharing the card over gloo (the
                counterpart of the JAX package's virtual devices), started
                once for phases 29-31, and a 1-rank nccl group; door-v0's
                body is built here before either starts. At N=1000 (250
                lanes a rank, ragged), H=20: the sharded kernel objective
                bit-identical to the unsharded launch, within TOL of the
                plain version, a NaN lane in rank 2's shard alone, the
                horizon mask, N=1002 raising "divide", exactly one launch
                a rank per call, every rank's costs identical; and
                hammer-v0-hand (a warp-layout body) at N=128 (32 lanes a
                rank), H=10: the sharded costs bit-identical to the
                unsharded launch, exactly one warp-layout launch a rank and
                none of the lane layout, every rank's costs identical;
 30. timings -- ``studies/mesh_megakernel_bench.py``'s configuration
                (door-v0, SE with lengthscale 4 dt, Lbps delta 0.9, H=160,
                N=16384): ms per synced PPI iteration unsharded, on the 4
                gloo ranks and on the 1 nccl rank; each rank's kernel ms on
                its 4096 lanes (CUDA events, one rank at a time); the
                all_reduce ms of the (N,) costs; the plain sharded
                objective at H=20. Four processes time-slice one card (no
                MPS): the 4-rank time measures overhead, not scale-out;
 31. episodes -- phase 4's canonical door-v0 episode through
                ``Mpc(mesh=make_mesh(4))``: phase 4's return to the last
                printed digit, the door open, exactly 800 launches a rank
                (550 planning + 250 real steps, each rank stepping its own
                replica), every rank's final policy state bit-identical to
                rank 0's; two T=20 door-v0 episodes on
                ``make_multislice_mesh(2, 2)`` (``mesh_axis=("slices",
                "samples")`` and ``"samples"``), each the unsharded T=20
                return with exactly 110 launches a rank. In the same
                4-rank group, the generic sharded objective
                (``parallel.sharded_objective``): ``run_opt
                --mesh-devices 4`` (Reps, NoisySphere, d=64, N=4096, 10
                iterations: the moment-match kernel's shape) and three
                iterations of ``run_policy_search --mesh-devices 4``
                (make policy-search's config, 32 trajectories a rank):
                the final policy state, every stat of the trace and the
                generator's state bit-identical to the unsharded runs
                (made in this process before the group starts), exactly
                10 moment-match and 3 ball-in-a-cup launches a rank; and
                ``goal_success --env pen-v0 --resets 4 --mesh-devices 4
                --timesteps 10`` (one episode a rank): every episode's
                return, success and goal bit-identical to the unsharded
                sweep of the same four resets, 80 launches a rank.
 32. build   -- the warp layout (``csrc/rollout_warp.cu``: one rollout a
                warp, the mass matrix and the solve spread over its lanes)
                of door-v0-adroit, hammer-v0-adroit, relocate-v0-adroit,
                door-v0-hand, relocate-v0-hand, hammer-v0-hand,
                pen-v0-adroit (its solve's constant head) and fetch-pick,
                built with nvcc beside phases 13's, 17's, 21's and 25's
                bodies, first of all builds; print each body's line count,
                nvcc seconds, shared memory a rollout and a block and
                -Xptxas -v summary next to its lane layout's;
 33. check   -- on phase 14's, 18's, 22's and 26's lanes (N=1000, H=3, 2,
                2, 10, 5, 5, 2 and 10): the warp layout bit for bit the
                lane kernel,
                and the plain version bit for bit (the relocate bodies'
                rewards within 1e-6: their division by the number of tip
                spheres); a NaN lane; a second frame,
                board or goal (the goal through the reward constants) that
                changes the
                rewards, with the mask on its costs, bit for bit the lane
                kernel's; N=1000 in blocks of 3 rollouts (ragged) into
                outputs padded with a sentinel past N that must stay; the
                real step (N=1, H=1) bit for bit ``plain_step`` (its reward
                within the same tolerance) and the lane kernel;
 34. timings -- CUDA events at each body's canonical shape (N=64/H=30,
                N=128/H=30, N=256/H=20, N=64/H=30, N=128/H=30, N=256/H=20,
                N=96/H=15, N=384/H=20): the lane layout at 128 threads a
                block and the warp layout as routed (the sweeps over block
                sizes, which re-timed PRs 9-12's choices, were cut), and
                both as the main path launches them in turns (lane, warp,
                warp, lane); the real
                step and a synced PPI iteration (the canonical solver and
                prior) in both layouts; then phase 16's, 20's, 24's and
                28's seed-0 episodes of the eight once more through the
                lane layout: exactly 800, 200, 330, 800, 200, 330, 350
                and 410 launches of it, the returns equal the warp
                layout's, the doors open, the ball and the pen at their
                goals.
 35. build   -- the split layout (``csrc/rollout_split.cu``: 32 rollouts
                a block, each rollout's substep and reward scheduled over
                the block's warps) of door-v0, which plans and steps
                through it (phases 2-31 run it), of hammer-v0, which
                keeps the lane layout, and of pen-v0-hand, relocate-v0,
                cheetah, pen-v0, walker2d, walker~walk, humanoid-standup,
                fetch-push, hopper, reacher and finger~spin, whose substep
                is partitioned by the body tree (pen-v0's, fetch-push's,
                hopper's, reacher's and finger~spin's with their heaviest
                chain cut into segments) and which plan and step through it (phases
                10-12 run relocate-v0, cheetah and pen-v0, phases 18-20
                pen-v0-hand, phases 22-24 the others); generated and
                built with nvcc in phase 1
                (door-v0's before phase 2, relocate-v0's, cheetah's and
                pen-v0's before phase 10, pen-v0-hand's before phase 18,
                the others' before phase 22, with their warp bodies for
                phase 37); print each
                body's line count, nvcc seconds, warps a group, phases,
                shared memory a group and -Xptxas -v summary next to its
                lane layout's;
 36. check   -- on phase 2's (door-v0), phase 18's (hammer-v0), phase
                10's (relocate-v0, cheetah, pen-v0), phase 18's
                (pen-v0-hand) and phase 22's (walker2d, walker~walk,
                humanoid-standup, fetch-push, hopper, reacher,
                finger~spin) lanes,
                N=1000, H=20 (door-v0) or 10: the split
                layout bit for bit the lane kernel and within TOL
                (SCENE_TOL) of the plain version; a NaN lane; the second
                frame, board, goal or start with the mask, both layouts'
                bits equal; N=1000 (31 groups and 8 rollouts) into outputs
                padded with a sentinel past N that must stay; the real step
                within the tolerance of ``plain_step`` and bit for bit both
                layouts';
 37. timings -- at each body's canonical shape, the lane and split
                kernels alone (lane-major inputs and outputs made once)
                in turns (lane, split, split, lane) after 0.5 s of the
                lane kernel's launches, 200 launches a reading; CUDA
                events of the main path's whole call in turns (lane,
                split, split, lane) at N=64/H=30 (door-v0, hammer-v0),
                and (lane, warp, split, split, warp, lane) at N=256/H=20
                (relocate-v0, fetch-push), N=256/H=30 (cheetah, walker2d,
                humanoid-standup, hopper), N=96/H=15 (pen-v0-hand,
                pen-v0), N=128/H=25 (walker~walk), N=64/H=20
                (reacher) and N=128/H=20 (finger~spin), and (lane, split, split, lane) for door-v0 at
                N=1024/H=160 (phase 3's north star), N=4096/H=160 (phase
                30's shard) and N=16384/H=160 and for pen-v0 at
                N=1024/H=160; the real step and a synced PPI
                iteration in the lane and split layouts; the split
                kernel's blocks an SM; then phase 4's door-v0 episode,
                phase 12's relocate-v0, cheetah and pen-v0 episodes,
                phase 20's pen-v0-hand episode and phase 24's walker2d,
                walker~walk, humanoid-standup, fetch-push, hopper, reacher
                and finger~spin (seed 0) episodes once more through the
                lane layout and phase 20's seed-0 hammer-v0 episode once
                more through the split layout: exactly 800, 330, 350,
                350, 350, 350, 350, 350, 290, 350, 210, 290 and 550
                launches of it, the returns equal.
 38. build   -- generate the ball-in-a-cup kernel's two bodies
                (``envs/physics/bic_kernel.py``: the canonical 12-particle
                string, 15 Jacobi sweeps, the same-step coupling) and
                build both layouts with nvcc in phase 1 beside the others
                (before phase 29, whose ranks launch the routed one): the
                one-thread layout ``csrc/bic_rollout.cu`` and the warp
                layout ``csrc/bic_rollout_warp.cu`` (a warp a trajectory,
                a point of the string a lane); print each one's line
                count, f32 ops a lane step, nvcc seconds, -Xptxas -v
                summary (registers, spills) and SASS counts (instructions,
                division checks, calls, local loads and stores), and the
                route (``bic_kernel.route``);
 39. check   -- the kernel as routed against its plain version (the eager
                scalar program) on the card at N=1000 over 10 stabilize +
                20 trajectory + 10 cool-down steps: the final lane states,
                rewards and success flags within BIC_TOL, BIC_STATS_TOL
                and BIC_REACTION_ATOL, a NaN setpoint in one lane that
                stays in it, and one launch into outputs padded with a
                sentinel past N that must stay (BIC_PAD_BLOCK a block, so
                the last block runs past N), bit for bit the wrapper's;
                the other layout bit for bit the routed one, NaN lane and
                all; the plain version's and the kernel's time at this
                shape; then the branch check on the raised-elbow lanes,
                both layouts bit for bit there too;
 40. timings -- both layouts through the wrapper in turns (thread, warp,
                warp, thread; CUDA events over BIC_TURN_LAUNCHES calls a
                reading) at the canonical search's shape (N=128, 250 +
                1000 + 350 steps) and at the check's, f32 ops a lane step
                and the bound;
 41. search  -- ``make policy-search`` (Reps, BallInACup, RbfFeatures,
                epsilon 2.0, 40 iterations, MonteCarlo, N=128, seed 0)
                through the port's run_policy_search and the routed
                layout: the success rate
                reaches 1.00 within the 40 iterations (the JAX package
                does at seeds 0-4, RESULTS.md:118-128), exactly 40 kernel
                launches (one an evaluation), all of the routed layout's
                kernel (each layout has its own counter), the curve at iterations 0,
                10, 20, 30 and 39 and the wall time; then the Test env
                through the same runner (Reps, epsilon 2.0, N=64, 20
                iterations): its final mean cost below 0.3 of its first,
                no launch; then three iterations of the canonical search
                through each layout (``bic_kernel.route`` patched for the
                run): the final state, the trace and the generator's state
                bit-identical, three launches of that layout's kernel and
                none of the other's. The canonical search runs with
                ``--render --plot``: ``ball_in_a_cup.gif`` (the final
                prior's mean trajectory traced step by step on the host,
                a frame every 8 steps), ``result.png`` and
                ``policy_samples.png`` decode; the traced trajectory's
                final state against one launch of the kernel on the same
                setpoints (its success flag equal, the errors reported),
                and at phase 39's depth (10 + 20 + 10 steps) within phase
                39's tolerances; the trace's seconds;
 42. episodes -- the pendulum swing-up (tests/test_mpc.py: Mppi alpha 10,
                WhiteNoiseIid, H=20, T=60, N=64, no warm start, seed 0):
                the last five rewards average above -1.0 and above the
                first five by 5.0; one cartpole episode (T=100, 10
                warm-start iterations) with a finite return; both plan
                through the eager objective (no kernel in either
                package), so no launch.
 43. resume  -- phase 4's episode through ``run_mpc --checkpoint-every 50
                --dir``, stopped by a hook that raises after the checkpoint
                at step 100, then ``--resume`` to the end: the joined track
                (action, reward, obs, ess, alpha, qpos) and the final env
                state bit for bit phase 4's, exactly 350 + 450 launches;
                then the crash window (the track of all 250 steps beside
                the checkpoint of step 200) resumed: trimmed to step 200,
                the same bits, 150 launches;
 44. prior   -- ``run_mpc --optimize-prior`` at phase 4's config: the
                hyperparameters change and stay inside ``param_bounds``,
                the fit launches no kernel (53 launches by the end of
                step 0), exactly 800 launches, the door open; the old and
                new hyperparameters and the fit's time printed; then
                ``model_selection --expert`` on phase 47's collect_expert
                npz (H=30, door-v0's dt; the SE family, the one run_mpc
                plans with, ``--kernels``) and ``run_mpc
                --model-selection`` with its artifact: finite return,
                exactly 800 launches, the fitted SE parameters, KL and
                success printed (success not gated): the reference's
                pipeline, expert -> model_selection -> run_mpc
                --model-selection (RESULTS.md:180-202);
 45. runners -- ``goal_success --env pen-v0 --resets 3`` (success rate >=
                2/3, the goals spread, 350 launches an episode);
                ``multi_start --env door-v0 --restarts 2`` (both restarts
                end on the task's frame, 800 launches each; returns and
                any-success printed); ``profile_mpc`` on one triple
                (door-v0, SE, Lbps, N=64: ms per control step, 21
                launches); ``corl_curves --seeds 1 --timesteps 60`` on
                door-v0 (three finite returns, overlay.png written, 570
                launches).
 46. experts -- the palm-IK kernel (``csrc/ik_palm.cu``, one thread running
                every iteration of an IK call) with the five bodies of
                ``envs/physics/ik_kernel.py`` (door-v0-hand, door-v0-adroit,
                hammer-v0-hand, hammer-v0-adroit, relocate-v0-adroit), built
                in phase 1 beside the others: nvcc seconds and -Xptxas -v;
                each against its plain version (autograd through the sites)
                at 20 iterations to IK_TOL, a NaN target all NaN; the
                kernel's time at its expert's iteration counts and at 2,
                the plain version's at 2, the bounds (f32 ops over the peak,
                and one thread's dependent chain). Then the seven scripted
                experts whole on the card to the JAX tests' gates:
                door-v0-hand on JAX's key(0) frame (door > 1.35),
                door-v0-adroit, relocate-v0-hand and relocate-v0-adroit
                (the ball at the goal and > table + radius + 0.1),
                hammer-v0-hand on the fixed board (nail > 0.95 depth,
                |hammer_x| < 0.3, lifted > 0.03) and on JAX's key(0) board,
                hammer-v0-adroit (nail > 0.95 depth, carried ham_z > 0.1),
                pen-v0-hand (final similarity > 0.85, max > start + 0.05,
                not dropped): exactly one rollout launch a step of each
                expert's frames and one IK launch a call its log records;
                each expert's wall, its IK kernel's time at its counts and
                the plain IK's estimate there (a measured iteration times
                the count);
 47. collect -- ``collect_expert`` at the canonical door-v0 config (Lbps,
                SE, delta 0.9, 2 iterations, anneal 0.5, lengthscale 0.08,
                N=64, H=30, T=250, 50 warm-start iterations, one episode):
                the npz's keys and shapes, exactly 800 launches; it runs
                after phase 43 and before phase 44, which reads its npz;
 48. sac     -- ``train_sac_expert`` on humanoid-standup: 5 chunks at the
                default sizes (64 steps, 64 updates of 256), then 200 steps
                of the trained policy's mean: finite losses, the actor
                moved, actions in the box, the npz's shapes, exactly
                5 x 64 + 200 launches.
 49. render  -- phase 4's door-v0 history (250 steps) on the card: the
                schematic (``render.render_door``, the FK of all 250
                frames in one call) to a GIF and to an MJPEG AVI, 125
                frames each, both decoded; the ray-caster
                (``render3d.render_trajectory``) at 320x240 over all 250
                frames, its ms a frame and its peak device memory (within
                ``render3d.MEMORY_BUDGET`` over what was allocated
                before), written to a GIF and decoded; 3 of its frames
                against the CPU's frames of the same qpos (at most 0.5% of
                pixels off by more than 1 level) and against themselves
                with TF32 allowed (equal); then ``run_mpc --render
                --render-3d --video-format avi`` on a T=20 door-v0 episode:
                exactly 110 launches, ``episode.avi``, ``episode_3d.gif``
                and the plots written and decoded;
 50. figures -- ``run_opt --plot`` (Reps, NoisySphere, d=64, N=4096, 10
                iterations: exactly 10 moment-match launches,
                ``result.png``), ``runners.figures`` (three PNGs) and
                ``runners.animations`` at 8, 2 a solver, 6 and 4 frames
                (four GIFs), each file decoded with its frame count.
Phases run in order but for 47, which runs between 43 and 44; each of
phases 43-50 prints its wall time. The card's machine has no matplotlib
and no imageio: phases 41, 49 and 50 draw with the port's PIL stand-in
(``utils.plotting``) and write GIFs with PIL.
Then one JSON line with the kernels' numbers (each entry with the (N, H)
of its ms and bound_ms, of its plain_ms, and the kernel's time at the
latter; the rollout bodies of phase 35 with their registers and spills,
their ``ms`` the main path's call and ``kernel_alone_ms`` the kernel alone;
the palm-IK kernel's five bodies with the iterations of their ``ms`` and
``bound_ms`` (the expert's first call's), of their ``plain_ms`` and the
kernel's time there, and ``chain_bound_ms``, one thread's dependent chain)
and, last, the device line.
All numbers also go to chip_smoke.json in the output directory.
"""

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_CHECK, H_CHECK = 1000, 20
# the horizon of phases 10 and 22's checks (phase 2's and 29's keep
# H_CHECK; phase 18's is H_SCENE): the plain version runs one eager op per scalar op, and the
# checks against it were 43% of the script at H=20 on an H100 (PERF.md)
H_EAGER = 10
# the horizon at which phases 11, 15, 19 and 23 time the plain rollout: one
# eager op per scalar op, the script's dearest part on a slow host (at the
# canonical horizons, 10-30, the script passed its 1,200 s on a host 1.4-2.5x
# slower in it)
H_PLAIN = 5
TOL = 1e-4  # max of |kernel - plain| / (1 + |plain|), elementwise
# moment match: the kernel against its plain version (f32 sums in another
# order: mu and sigma absolute, ESS relative) ...
MM_TOL = 1e-5
# ... and both against the float64 oracle (tests/test_fuzz_solvers.py)
ORACLE_MU_ATOL, ORACLE_SIGMA_RTOL, ORACLE_SIGMA_ATOL, ORACLE_ESS_RTOL = (
    5e-4, 2e-2, 5e-2, 1e-3)
# phase 8 bounds, set from the port's CPU runs with seeds 0-4 (PERF.md)
RUNS = (  # (dimension, n_samples, launches, bound on the final cost)
    (640, 4096, 50, "ratio"), (64, 4096, 50, 400.0), (20, 100, 0, 100.0))
FINAL_RATIO = 0.5  # d=640: final cost <= this x the first iteration's
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): f32 outside the
# tensor cores and device-memory bandwidth; a kernel's bound is the larger
# of its operations and its bytes over these
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
PEAK_TF32_FLOPS = 495e12   # dense TF32 on the tensor cores

# phases 9-12: the variant-(b) envs. Per env: the scale of the random check
# actions (cheetah's reach past its +-30 box), two pinned goals away from
# the reward's bonus thresholds (pen-v0: yaw/pitch with a similarity below
# 0.6 to the reset axis, which stays below 0.75 over the check's steps;
# relocate-v0: goals more than 0.25 from the ball, which falls freely from
# 0.9 above the table, clear of the gripper, and stays 0.1 above the lift
# gate), the canonical kernel shape, and the runner's arguments for the
# episode with its expected launches (warm start + iterations + real steps,
# each real step one launch at N=1, H=1); the solver and prior of the
# canonical config, for the timed PPI iteration.
VARIANT_B = {
    "pen-v0": dict(
        scale=0.12, goals=((0.9, -0.6), (-0.95, 0.5)), shape=(96, 15),
        family=("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08}),
        episode=["Lbps", "pen-v0", "SquaredExponentialKernel", "--delta",
                 "0.9", "--n-iters", "2", "--anneal", "0.5", "--lengthscale",
                 "0.08", "--timesteps", "100", "--horizon", "15"],
        n_samples=96, launches=50 + 100 * 2 + 100),
    "relocate-v0": dict(
        scale=0.3, goals=((0.55, 0.15, 0.85), (0.65, 0.10, 0.88)),
        shape=(256, 20), family=("Mppi", "ColouredNoise", {"beta": 2.0}),
        episode=["Mppi", "relocate-v0", "ColouredNoise", "--beta", "2",
                 "--alpha", "10", "--anneal", "0.9", "--timesteps", "140",
                 "--horizon", "20"],
        n_samples=256, launches=50 + 140 + 140),
    "cheetah": dict(
        scale=25.0, goals=None, shape=(256, 30),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}),
        episode=["Mppi", "cheetah", "ColouredNoise", "--beta", "2",
                 "--timesteps", "150"],
        n_samples=256, launches=50 + 150 + 150),
}
DOOR_CEM = dict(episode=["Cem", "door-v0", "WhiteNoiseIid", "--n-elites",
                         "10", "--timesteps", "100"], n_samples=64,
                launches=50 + 100 + 100)

# phases 13-16: the hand door scenes (variants c and d). Per env: the check
# horizon, the seeds of phase 16 and how many must open the door, the
# horizons of the kernel's and the plain rollout's timings. Every
# episode runs the canonical config (``goal_success.py:63-66,74-77``); seed
# 0 launches the kernel 50 + 250 x 2 + 250 times (its real step is one
# launch too).
HAND = {"door-v0-hand": dict(h_check=10, h_frame=5, seeds=range(2),
                             successes=1, h_time=30, h_plain=H_PLAIN),
        "door-v0-adroit": dict(h_check=3, h_frame=2, seeds=range(1),
                               successes=1, h_time=10, h_plain=1)}
HAND_EPISODE = ["Lbps", "SquaredExponentialKernel", "--delta", "0.9",
                "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
                "--timesteps", "250", "--horizon", "30"]
HAND_LAUNCHES = 50 + 250 * 2 + 250
H_FRAME = 5  # horizon of the mask and second-frame checks

# phases 17-20: hammer-v0 (make mpc-essps) and the three 3-digit hand
# scenes at their canonical configs (``goal_success.py:29-31,38-40,57-58,
# 67-70``). Per env: the check horizon and the scale of its random actions
# about the initial posture, the coordinates of the object that the check's
# contacts must move in some lanes, the canonical kernel shape, the solver
# and prior of the timed PPI iteration, the runner's arguments, the seeds,
# the launches of each episode (warm start + iterations + real steps, which
# are launches too) and how many episodes must succeed.
SCENE_TOL = 1e-6  # max of |kernel - plain| / (1 + |plain|), elementwise
# the hammer scenes' episodes (hammer-v0-hand, hammer-v0-adroit): 50 of
# the canonical 400 steps. Their success is not gated (the JAX package's
# rates are ~1/5-3/5 and 0), and at 400 steps they were the script's
# dearest episodes, run in both layouts
T_HAMMER = 50
_LBPS_SE = ["SquaredExponentialKernel", "--delta", "0.9", "--n-iters", "2",
            "--anneal", "0.5", "--lengthscale", "0.08"]
# the horizons of phase 18's check against the eager plain rollout and of
# its mask and second board or goal, below H_EAGER and H_FRAME to keep the
# script inside its 1,200 s on a slow host. relocate-v0-hand's
# mask and second goal keep H_FRAME: within 3 steps no lane lifts the ball
# to where the goal enters the reward
H_SCENE, H_SCENE_FRAME = 5, 3
SCENES = {
    "hammer-v0": dict(
        h_check=H_SCENE, h_frame=H_SCENE_FRAME, scale=0.4, moved=(4,),
        shape=(64, 30),
        family=("Essps", "RffFeatures", {"lengthscale": 0.15}),
        episode=["Essps", "hammer-v0", "RffFeatures", "--n-elites", "10",
                 "--lengthscale", "0.15"],
        seeds=range(3), launches=50 + 250 + 250, successes=2),
    "pen-v0-hand": dict(
        h_check=H_SCENE, h_frame=H_SCENE_FRAME, scale=0.5, moved=(3, 4),
        shape=(96, 15),
        family=("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08}),
        episode=["Lbps", "pen-v0-hand", *_LBPS_SE, "--timesteps", "100",
                 "--horizon", "15"],
        seeds=range(1), launches=50 + 100 * 2 + 100, successes=1),
    "relocate-v0-hand": dict(
        h_check=H_SCENE, scale=0.3, moved=(10, 11), shape=(256, 20),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}),
        episode=["Mppi", "relocate-v0-hand", "ColouredNoise", "--beta", "2",
                 "--alpha", "10", "--anneal", "0.9", "--timesteps", "140",
                 "--horizon", "20"],
        seeds=range(1), launches=50 + 140 + 140, successes=1),
    "hammer-v0-hand": dict(
        h_check=H_SCENE, h_frame=H_SCENE_FRAME, scale=0.3, moved=(9,),
        shape=(128, 30),
        family=("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08}),
        episode=["Lbps", "hammer-v0-hand", *_LBPS_SE, "--timesteps",
                 str(T_HAMMER), "--horizon", "30"],
        seeds=range(1), launches=50 + T_HAMMER * 3, successes=0),
}
# phase 20's short episodes: the priors that no other phase runs (with
# --beta 0.5, the smoothing coefficient of the two smoothed-noise priors)
OTHER_PRIORS = ("RbfFeatures", "Matern12Kernel", "Matern32Kernel",
                "Matern52Kernel", "PeriodicKernel", "WhiteNoiseKernel",
                "LinearGaussianDynamicalSystemKernel", "SmoothActionNoise",
                "SmoothExplorationNoise")
T_SHORT = 20

# phases 21-24: the remaining variant-(b) bodies at the JAX repo's configs
# (``tests/test_envs.py:16-48`` for reacher, ``studies/reset_parity.py:
# 24-29`` for finger~spin and walker~walk, ``goal_success.py:41-50`` for
# fetch-push and fetch-pick, the goal_success Mppi config at 256 samples for
# hopper, walker2d and humanoid-standup). Per env: the check's start
# ("contact": a pinned posture in contact, see ``rest_state``) and the scale
# of its random actions (about the arm's posture where the actions are PD
# targets), the coordinates that only the contact moves (or the foot
# spheres that end on the ground), a second target or goal, the canonical
# kernel shape, the prior and solver, the runner's arguments, the seeds and
# how many of them must pass the episode gate. reacher and fetch-push take
# more seeds than one: the JAX package's reacher reaches 0.08 at 5 of 10
# sampled targets at this config, and its fetch-push fails the port's seed-0
# scene (box at (0.540, 0.167), goal (0.682, 0.189)) at 1 of 3 agent seeds.
_MPPI_COLOURED = ["ColouredNoise", "--beta", "2", "--alpha", "10",
                  "--anneal", "0.9"]
REST = {
    "reacher": dict(
        scale=1.5, moved=None, feet=None, second=(-0.12, 0.1),
        shape=(64, 20), family=("Mppi", "WhiteNoiseIid", {}, 5.0),
        episode=["Mppi", "reacher", "WhiteNoiseIid", "--alpha", "5",
                 "--timesteps", "80", "--horizon", "20"], seeds=range(10),
        need=3),
    "finger~spin": dict(
        scale=5.0, moved=(2,), feet=None, second=None, shape=(128, 20),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "finger~spin", *_MPPI_COLOURED, "--timesteps",
                 "120", "--horizon", "20"], seeds=(0,), need=1),
    "fetch-push": dict(
        scale=1.2, moved=(4, 5), feet=None, second=(0.67, 0.0),
        shape=(256, 20),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "fetch-push", *_MPPI_COLOURED, "--timesteps", "120",
                 "--horizon", "20"], seeds=range(5), need=3),
    "fetch-pick": dict(
        scale=0.4, moved=(6, 7), feet=None, second=(0.60, 0.07, 0.64),
        shape=(384, 20),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "fetch-pick", *_MPPI_COLOURED, "--timesteps", "180",
                 "--horizon", "20"], seeds=range(3), need=2),
    "hopper": dict(
        scale=0.75, moved=None, feet=(0, 1), second=None, shape=(256, 30),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "hopper", *_MPPI_COLOURED, "--timesteps", "150",
                 "--horizon", "30"], seeds=(0,), need=1),
    "walker2d": dict(
        scale=0.75, moved=None, feet=(0, 1, 2, 3), second=None,
        shape=(256, 30),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "walker2d", *_MPPI_COLOURED, "--timesteps", "150",
                 "--horizon", "30"], seeds=(0,), need=1),
    "walker~walk": dict(
        scale=0.75, moved=None, feet=(0, 1, 2, 3), second=None,
        shape=(128, 25),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "walker~walk", *_MPPI_COLOURED, "--timesteps",
                 "150", "--horizon", "25"], seeds=(0,), need=1),
    "humanoid-standup": dict(
        scale=0.75, moved=None, feet=(5, 6), second=None, shape=(256, 30),
        family=("Mppi", "ColouredNoise", {"beta": 2.0}, 10.0),
        episode=["Mppi", "humanoid-standup", *_MPPI_COLOURED, "--timesteps",
                 "150", "--horizon", "30"], seeds=(0,), need=1),
}
# contact starts: finger~spin's tip 5 mm into the paddle's pad; fetch-push's
# box under the paddle (8 mm overlap); fetch-pick's ball against a fingertip
# of the open gripper (5 mm)
FINGER_CONTACT_Q = (-0.25, -0.5, 0.0)
PUSH_CONTACT_START = (0.15, -0.1)
PICK_CONTACT_START = (0.0, 0.07)
STANDUP_LYING = 150 * 0.22 / 0.3   # what lying still earns in 150 steps


def rest_launches(name):
    """Launches of one of phase 24's episodes: 50 warm-start iterations,
    then T iterations and T real steps."""
    episode = REST[name]["episode"]
    return 50 + 2 * int(episode[episode.index("--timesteps") + 1])

# phases 25-28: the three Adroit-class scenes (20-25 DoF) at their
# canonical configs (``goal_success.py:78-92``). Per env: the check
# horizon and the scale of its random actions about the actuated joints'
# posture, the first actuated coordinate, the coordinates that only a
# contact moves, the canonical kernel shape, the plain rollout's timed
# shape, the prior and solver, the runner's arguments, the launches of the
# seed-0 episode (warm start + iterations + real steps) and whether it must
# succeed. The plain version runs one eager op per scalar op, 191k-465k
# of them a lane step (1-6 s a step on the card's host): the check runs
# at H=2 (3 before the palm-IK phases came), its mask at H=2 and its second
# goal or board at H=1 (``h_second``; 2 before), not at H=20 and 5, and
# the real step is timed through the kernel only. At the cut horizons the
# contact lanes still move the object (pen-v0-adroit 850, relocate-v0-
# adroit 18, hammer-v0-adroit 500 of 1,000) and the second goal or board
# changes every lane's cost, the plain version in the kernel's place on
# the CPU.
ADROIT = {
    "pen-v0-adroit": dict(
        h_check=2, h_frame=2, h_second=1, scale=0.5, act0=5, moved=(3, 4),
        shape=(96, 15), plain_shape=(64, 1), eager_step=False,
        family=("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08}),
        episode=["Lbps", "pen-v0-adroit", *_LBPS_SE, "--timesteps", "100",
                 "--horizon", "15"],
        launches=50 + 100 * 2 + 100, success=True),
    "relocate-v0-adroit": dict(
        h_check=2, h_frame=2, h_second=1, scale=0.3, act0=0, moved=(21, 22),
        shape=(256, 20), plain_shape=(64, 1), eager_step=False,
        family=("Mppi", "ColouredNoise", {"beta": 2.0}),
        episode=["Mppi", "relocate-v0-adroit", "ColouredNoise", "--beta",
                 "2", "--alpha", "10", "--anneal", "0.9", "--timesteps",
                 "140", "--horizon", "20"],
        launches=50 + 140 + 140, success=True),
    "hammer-v0-adroit": dict(
        h_check=2, h_frame=2, h_second=1, scale=0.3, act0=0, moved=(24,),
        shape=(128, 30), plain_shape=(64, 1), eager_step=False,
        family=("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08}),
        episode=["Lbps", "hammer-v0-adroit", *_LBPS_SE, "--timesteps",
                 str(T_HAMMER), "--horizon", "30"],
        launches=50 + T_HAMMER * 3, success=False),
}


# phases 32-34: the warp layout (csrc/rollout_warp.cu), through which
# door-v0-hand, door-v0-adroit, relocate-v0-adroit, hammer-v0-adroit,
# relocate-v0-hand, hammer-v0-hand, pen-v0-adroit and fetch-pick plan and
# step (phases 13-28 run it; pen-v0-adroit's solve starts with its
# constant head, PPI_SOLVE_FROM 3). Per env: the canonical kernel shape,
# and whether its rewards equal the plain version's bit for bit or only
# within SCENE_TOL (the relocate bodies' rewards divide a sum over the tip
# spheres by their number, 10 or 6: PyTorch on the card multiplies by the
# reciprocal, the kernel divides, and the one-ulp quotient carries through
# the rest of the reward; fetch-pick divides by its 4 tips, exactly).
# Phase 16 (HAND), 20 (SCENES), 24 (REST, seed 0 only) or 28 (ADROIT)
# gives its episode, return and launches, and its canonical solver and
# prior; phase 34 sets the env's class to the lane layout for the second
# episode. Phase 32 prints each body's shared memory a block at each of
# WARP_SIZES rollouts a block; SENTINEL_WARPS rollouts a block leave
# N_CHECK ragged for the sentinel check.
WARP = {"door-v0-adroit": dict(shape=(64, 30), exact_rewards=True),
        "hammer-v0-adroit": dict(shape=(128, 30), exact_rewards=True),
        "relocate-v0-adroit": dict(shape=(256, 20), exact_rewards=False),
        "door-v0-hand": dict(shape=(64, 30), exact_rewards=True),
        "hammer-v0-hand": dict(shape=(128, 30), exact_rewards=True),
        "relocate-v0-hand": dict(shape=(256, 20), exact_rewards=False),
        "pen-v0-adroit": dict(shape=(96, 15), exact_rewards=True),
        "fetch-pick": dict(shape=(384, 20), exact_rewards=True)}
WARP_SIZES = (1, 2, 4, 8)
HAND_FAMILY = ("Lbps", "SquaredExponentialKernel", {"lengthscale": 0.08})
SENTINEL, SENTINEL_WARPS, SENTINEL_PAD = -12345.0, 3, 64
CHECKED = {}   # phases 14, 18, 22 and 26 keep their inputs and outputs

# each layout's skeleton in ppi_tpu_torch/csrc
SOURCES = {"lane": "rollout.cu", "warp": "rollout_warp.cu",
           "split": "rollout_split.cu"}

# phases 35-37: the split layout (csrc/rollout_split.cu) of door-v0,
# hammer-v0, pen-v0-hand, relocate-v0, cheetah, pen-v0, walker2d,
# walker~walk, humanoid-standup, fetch-push, hopper, reacher and
# finger~spin: each rollout's substep and reward spread over the warps of
# a block (all but door-v0 and hammer-v0 partitioned by the body tree,
# pen-v0's, fetch-push's, hopper's, reacher's and finger~spin's with their
# heaviest chain of bodies cut into segments, ``scalar_split_partition``).
# Per env:
# the layout it is routed to, the canonical shape, the larger shapes it is
# timed at in turns with the lane layout (door-v0's body also runs phase
# 3's north star and phase 30's 4096-lane shard; pen-v0's phase 11's
# N=1024/H=160), whether the warp layout
# joins the turns at the canonical shape, the check's tolerance against
# plain, and its episode (phase 4's, 20's, 12's or 24's seed 0) with its
# launches, run once more through the other layout.
SPLIT = {"door-v0": dict(routed="split", shape=(64, 30),
                         big=((1024, 160), (4096, 160), (16384, 160)),
                         tol=TOL, episode=None, launches=800),
         **{name: dict(routed=routed, shape=SCENES[name]["shape"], big=(),
                       warp=routed == "split", tol=SCENE_TOL,
                       episode=SCENES[name]["episode"],
                       launches=SCENES[name]["launches"])
            for name, routed in (("hammer-v0", "lane"),
                                 ("pen-v0-hand", "split"))},
         **{name: dict(routed="split", shape=VARIANT_B[name]["shape"],
                       big=((1024, 160),) if name == "pen-v0" else (),
                       warp=True, tol=TOL,
                       episode=VARIANT_B[name]["episode"],
                       launches=VARIANT_B[name]["launches"])
            for name in ("relocate-v0", "cheetah", "pen-v0")},
         **{name: dict(routed="split", shape=REST[name]["shape"], big=(),
                       warp=True, tol=TOL, episode=REST[name]["episode"],
                       launches=rest_launches(name))
            for name in ("walker2d", "walker~walk", "humanoid-standup",
                         "fetch-push", "hopper", "reacher", "finger~spin")}}

# phases 29-31: the sharded entry. The check's NaN lane lies in rank 2's
# shard (lanes 500-749 of N_CHECK); the timing runs the configuration of
# ``studies/mesh_megakernel_bench.py`` ("the 16k+-sample sweep"); its plain
# version is timed at H=20 (one eager op per scalar op: ~13 s at H=160).
MESH_RANKS = 4
MESH_NAN_LANE = 600
# phase 29's warp-layout body and its (N, H)
MESH_WARP, N_MESH_WARP, H_MESH_WARP = "hammer-v0-hand", 128, 10
N_MESH, H_MESH, H_MESH_PLAIN, MESH_ITERS = 16384, 160, 20, 10
# phase 4's canonical door-v0 episode (``make mpc-lbps``) at T timesteps
DOOR_ARGS = ["Lbps", "door-v0", "SquaredExponentialKernel", "--delta", "0.9",
             "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
             "--horizon", "30"]


# phases 38-42: the ball-in-a-cup kernel, make policy-search and the classic
# envs. The check's phases (stabilize, trajectory, cool-down) are cut from
# the canonical 250 + 1000 + 350 steps: its plain version is ~23k eager ops
# a lane step. Its tolerances, kernel against plain: the coordinates, the
# particles and the reward to BIC_TOL of 1 + |plain| (PyTorch on the card
# divides by a Python scalar as a product with its reciprocal, the kernel
# divides), the statistics (sums of squared velocities, differences over
# dt) to BIC_STATS_TOL, the string's reaction (a second difference over
# dt^2) to BIC_REACTION_ATOL newtons, the success flags exactly
BIC_N_CHECK, BIC_PHASES, BIC_NAN_LANE = 1000, (10, 20, 10), 321
BIC_TOL, BIC_STATS_TOL, BIC_REACTION_ATOL = 1e-4, 1e-3, 1e-2
# the branch check: BIC_BRANCH_N lanes that hold a raised elbow
# (BIC_CATCH_RANGE: the shoulder's and the elbow's setpoints) over 60
# trajectory steps, where some catch the ball and some hit the arm with
# it, against the plain version on the host's CPU (~23k eager ops a step
# cost less there than launched on the card), to the check's tolerances
# and the success and violation flags exactly. In this regime the swing
# on a slack string amplifies a last-bit difference (sinf, a division)
# some ten-fold every 10 steps after the first 20: the card read 1.0e-5,
# 4.0e-4 and 1.8e-3 N on these lanes (NVIDIA H100 80GB HBM3, 700.00 W),
# the host-C build on a CPU up to 1.3e-4 and 2.3e-2 N on other seeds
BIC_BRANCH_N, BIC_BRANCH_PHASES = 64, (5, 60, 5)
BIC_CATCH_RANGE = ((0.2, 1.2), (2.4, 2.9))
BIC_Q_START = (0.0, 0.0, 0.0, 1.5707)
# the canonical search (make policy-search, RESULTS.md:118-128): 128
# trajectories of 250 + 1000 + 350 steps an iteration, 40 iterations
BIC_N_TIME, BIC_T = 128, 1000
# phase 40's calls a reading, each layout's, in turns (thread, warp, warp,
# thread): the one-thread layout takes ~0.74 s a call at N=128
BIC_TURN_LAUNCHES = {"thread": 2, "warp": 5}
# the trajectories a block of phase 39's padded launch: neither divides
# N=1000, so its last block runs past N (31 blocks of 32 and one of 8; 333
# of 3 and one of 1)
BIC_PAD_BLOCK = {"thread": 32, "warp": 3}
POLICY_SEARCH = ["Reps", "BallInACup", "RbfFeatures", "--epsilon", "2.0",
                 "--n-iters", "40", "--seed", "0", "--device", "cuda",
                 "MonteCarlo", "--n-samples", "128"]
# phase 49's run_mpc --render --render-3d episode (door-v0, phase 4's
# config): 50 + 3 T launches
RENDER_T = 20
# phase 50's run_opt --plot: N d at the moment match's dispatch threshold
PLOT_OPT = ["Reps", "NoisySphere", "--dimension", "64", "--n-iter", "10",
            "--seed", "0", "--plot", "--device", "cuda", "mc",
            "--n-samples", "4096"]
TEST_SEARCH = ["Reps", "Test", "RbfFeatures", "--epsilon", "2.0",
               "--n-iters", "20", "--seed", "0", "--device", "cuda",
               "MonteCarlo", "--n-samples", "64"]
# tests/test_mpc.py's pendulum swing-up (Mppi alpha 10, WhiteNoiseIid,
# H=20, T=60, N=64, no warm start) and one cartpole episode
PENDULUM = ["Mppi", "pendulum", "WhiteNoiseIid", "--alpha", "10",
            "--timesteps", "60", "--horizon", "20", "--n-warmstart-iters",
            "0", "--seed", "0", "--device", "cuda", "MonteCarlo",
            "--n-samples", "64"]
CARTPOLE = ["Mppi", "cartpole", "WhiteNoiseIid", "--alpha", "10",
            "--timesteps", "100", "--horizon", "20", "--n-warmstart-iters",
            "10", "--seed", "0", "--device", "cuda", "MonteCarlo",
            "--n-samples", "64"]
# phase 31's group also runs run_opt --mesh-devices 4 at a shape that
# takes the moment-match kernel (N d = KERNEL_MIN_ELEMENTS, d >= 8) and a
# few iterations of the sharded search; the parent runs both unsharded
MESH_OPT = ["Reps", "NoisySphere", "--dimension", "64", "--n-iter", "10",
            "--seed", "0", "--device", "cuda", "--mesh-devices", "4", "mc",
            "--n-samples", "4096"]
MESH_SEARCH = POLICY_SEARCH[:5] + ["--n-iters", "3", "--seed", "0",
                                   "--device", "cuda", "--mesh-devices",
                                   "4", "MonteCarlo", "--n-samples", "128"]


def door_args(timesteps, device="cuda"):
    return DOOR_ARGS + ["--timesteps", str(timesteps),
                        "--n-warmstart-iters", "50", "--seed", "0",
                        "--device", device, "MonteCarlo", "--n-samples", "64"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_timed(source, headers=None):
    from ppi_tpu_torch.build import build_library
    t0 = time.perf_counter()
    lib = build_library(source, headers)
    return lib, time.perf_counter() - t0


def ptxas_summary(lib):
    return [ln.strip() for ln in (lib.parent / "build.log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln]


def oracle_moments(log_w, x):
    """float64 moment match on the card (tests/test_fuzz_solvers.py)."""
    lw, x = log_w.double(), x.double()
    w = torch.exp(lw - lw.max())
    w = w / w.sum()
    mu = w @ x
    dev = x - mu
    return mu, (w[:, None] * dev).T @ dev, 1.0 / (w * w).sum()


def variant_b_state(env, name, dev, goal_index=0):
    """The check's initial state: a pinned goal (pen-v0, relocate-v0) or a
    start from the reset's noise (cheetah)."""
    from ppi_tpu_torch.envs.pen import axis_from_angles
    from ppi_tpu_torch.envs.physics.engine import PhysicsState
    goals = VARIANT_B[name]["goals"]
    if name == "pen-v0":
        return env.reset(None, dev, goal=axis_from_angles(*goals[goal_index]))
    if name == "relocate-v0":
        from ppi_tpu_torch.envs.relocate import BALL_Z
        s = env.reset(None, dev, goal=goals[goal_index], start=(0.0, -0.15))
        qpos = s.physics.qpos.clone()
        qpos[BALL_Z] = 0.9
        return dataclasses.replace(s, physics=PhysicsState(
            qpos=qpos, qvel=s.physics.qvel))
    return env.reset(torch.Generator(dev).manual_seed(goal_index), dev)


def env_header(env):
    """The generated body the main path builds for ``env``."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    return rk.generate_env_header(*rk.body_args(env, state))


def least_time(ops, nbytes, peak=PEAK_F32_FLOPS):
    """(least time in ms, what bounds it): the larger of the operations over
    ``peak`` (the f32 SIMT peak unless given) and the bytes over the memory
    rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def rollout_bound(env, n, horizon):
    """Bound of one rollout launch: the f32 operations the generated body
    does (N x H x ops per lane step, ``ops_per_lane_step``) and the bytes
    it must move (initial state and actions in, rewards and final state
    out)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    ops = n * horizon * rk.ops_per_lane_step(*rk.body_args(env, state))
    nq = env._model.nq
    nbytes = 4 * n * (2 * nq + horizon * env.action_dim + horizon + 2 * nq)
    return least_time(ops, nbytes)


def lanes(state, n):
    return (state.physics.qpos.expand(n, -1).contiguous(),
            state.physics.qvel.expand(n, -1).contiguous())


def check_variant_b(name, env, dev):
    """Phase 10 for one env: (errors, max abs error)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    cfg = VARIANT_B[name]
    rng = np.random.default_rng(1)
    acts = torch.from_numpy((cfg["scale"] * rng.standard_normal(
        (N_CHECK, H_EAGER, env.action_dim))).astype(np.float32)).to(dev)
    s0 = variant_b_state(env, name, dev)
    consts, _, _ = rk.kernel_operands(env, s0)
    run = rk.env_rollout(env, s0, H_EAGER)
    q0, qd0 = lanes(s0, N_CHECK)
    rew, qf, qdf = run(q0, qd0, acts, consts=consts)
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    torch.cuda.synchronize()
    errs = {"rewards": rel_err(rew, rew_p), "qf": rel_err(qf, qf_p),
            "qdf": rel_err(qdf, qdf_p)}
    max_abs = max(float((a - b).abs().max())
                  for a, b in ((rew, rew_p), (qf, qf_p), (qdf, qdf_p)))
    check(max(errs.values()) <= TOL, f"{name}: kernel vs plain {errs} > {TOL}")
    if name in SPLIT:   # phase 36 holds the other layout to these lanes
        CHECKED[name] = dict(s0=s0, q0=q0, qd0=qd0, acts=acts,
                             s1=variant_b_state(env, name, dev, 1),
                             h_frame=H_FRAME, plain=(rew_p, qf_p, qdf_p))

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, consts=consts)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          f"{name}: a NaN lane must go NaN alone")

    # the objective over the first H_FRAME steps (their plain rewards are
    # the first H_FRAME columns): the mask, and a second goal
    a = acts[:, :H_FRAME].contiguous()
    mask = (torch.arange(H_FRAME, device=dev) < H_FRAME - 2).float()
    c_k = rk.kernel_mpc_objective(env, s0, H_FRAME, mask)(None, a)
    c_full = rk.kernel_mpc_objective(env, s0, H_FRAME)(None, a)
    errs["masked_costs"] = rel_err(c_k, -(rew_p[:, :H_FRAME] * mask).sum(1))
    check(errs["masked_costs"] <= TOL
          and bool(torch.allclose(c_k, -(rew[:, :H_FRAME] * mask).sum(1)))
          and not bool(torch.allclose(c_k, c_full)),
          f"{name}: horizon mask {errs['masked_costs']}")

    if cfg["goals"] is not None:
        s1 = variant_b_state(env, name, dev, 1)
        c_k1 = rk.kernel_mpc_objective(env, s1, H_FRAME)(None, a)
        q1, qd1 = lanes(s1, N_CHECK)
        rew_p1 = rk.env_plain_rollout(env, s1, q1, qd1, a)[0]
        errs["second_goal_costs"] = rel_err(c_k1, -rew_p1.sum(1))
        check(errs["second_goal_costs"] <= TOL
              and float((c_k1 - c_full).abs().min()) > 1e-4,
              f"{name}: second goal {errs['second_goal_costs']}, or the "
              "goal does not change every cost")
    else:
        # the action reward sees the raw action and clips it itself
        past = float((acts.abs() > env.max_torque).float().mean())
        rew_c, qf_c, _ = run(q0, qd0, acts.clamp(-env.max_torque,
                                                 env.max_torque))
        check(past > 0.1 and bool(torch.equal(rew_c, rew))
              and bool(torch.equal(qf_c, qf)),
              f"{name}: actions past the box ({past:.2f} of them) change "
              "the result of the clip")
        errs["past_box_share"] = past

    # the real step: one launch at N=1, H=1 against the eager step
    action = acts[N_CHECK // 2, 0]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    errs["real_step"] = max(rel_err(s_k.physics.qpos, s_e.physics.qpos),
                            rel_err(s_k.physics.qvel, s_e.physics.qvel),
                            rel_err(r_k, r_e))
    check(errs["real_step"] <= TOL and int(s_k.t) == 1,
          f"{name}: real step {errs['real_step']}")
    return errs, max_abs


def time_variant_b(name, env, dev):
    """Phase 11 for one env: the kernel at the canonical shape (and
    pen-v0's at N=1024/H=160), the kernel and the plain rollout at the
    canonical N and H_PLAIN, one synced PPI iteration at the canonical
    shape, one real env step through the kernel and one eager."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    cfg = VARIANT_B[name]
    rng = np.random.default_rng(3)
    s0 = variant_b_state(env, name, dev)
    consts, _, _ = rk.kernel_operands(env, s0)
    out = {}
    shapes = [cfg["shape"]] + ([(1024, 160)] if name == "pen-v0" else [])
    for n, h in shapes:
        a = torch.from_numpy((cfg["scale"] * rng.standard_normal(
            (n, h, env.action_dim))).astype(np.float32)).to(dev)
        qn, qdn = lanes(s0, n)
        r = rk.env_rollout(env, s0, h)
        out[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
            lambda: r(qn, qdn, a, consts=consts), 20)
        out[f"bound_ms_N{n}_H{h}"], out["bound_by"] = rollout_bound(env, n,
                                                                    h)
    n, h = cfg["shape"][0], H_PLAIN   # the plain rollout's shape
    a = torch.from_numpy((cfg["scale"] * rng.standard_normal(
        (n, h, env.action_dim))).astype(np.float32)).to(dev)
    qn, qdn = lanes(s0, n)
    r = rk.env_rollout(env, s0, h)
    out[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
        lambda: r(qn, qdn, a, consts=consts), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.env_plain_rollout(env, s0, qn, qdn, a)
    torch.cuda.synchronize()
    out[f"plain_ms_N{n}_H{h}"] = 1e3 * (time.perf_counter() - t0)
    n, h = cfg["shape"]

    alg, policy, kwargs = cfg["family"]
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        policy, env.dt * torch.arange(h), env.action_dim, mean, cov_in,
        cov_out, lower=env.action_low, upper=env.action_high, device=dev,
        **kwargs)
    step = _one_iteration(make_solver(alg, delta=0.9, alpha=10.0), family,
                          rk.kernel_mpc_objective(env, s0, h), n)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, (stats, _, _) = step(state, gen)
        torch.cuda.synchronize()
    out[f"ppi_iter_ms_N{n}_H{h}"] = 1e3 * (time.perf_counter() - t0) / 10
    check(bool(torch.isfinite(stats["mean"])),
          f"{name}: PPI iteration cost not finite")

    action = family.predict_mean(state)[0]
    for label, fn, iters in (("kernel_step_ms", env.step, 20),
                             ("eager_step_ms", env.plain_step, 1)):
        fn(s0, action)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            s1, _ = fn(s0, action)
        torch.cuda.synchronize()
        out[label] = 1e3 * (time.perf_counter() - t0) / iters
        check(bool(torch.isfinite(s1.physics.qpos).all()),
              f"{name}: real env step not finite")
    return out


def hand_lanes(env, dev, n, h, seed=1):
    """Phase 14's lanes from a frame sampled with ``seed``: the reset
    posture in the first half, then the door opening at 1 rad/s from 0.02
    rad with the latch up (the bolt clamp holds it) and, in the last
    quarter, with the latch pressed to -1.0, past the unlock angle (it does
    not); actions are the initial posture plus 0.3 z."""
    s0 = env.reset(torch.Generator(dev).manual_seed(seed), dev)
    q0, qd0 = (x.clone() for x in lanes(s0, n))
    door, latch = env.scalar_dyn_body, env._latch
    q0[n // 2:, door] = 0.02
    qd0[n // 2:, door] = 1.0
    q0[3 * n // 4:, latch] = -1.0
    rng = np.random.default_rng(seed)
    acts = q0[:, None, :env.action_dim] + torch.from_numpy(
        (0.3 * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(dev)
    return s0, q0, qd0, acts


def check_hand(name, env, dev):
    """Phase 14 for one env: (errors, max abs error, clamp counts)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    h, hf = HAND[name]["h_check"], HAND[name]["h_frame"]
    s0, q0, qd0, acts = hand_lanes(env, dev, N_CHECK, h)
    run = rk.env_rollout(env, s0, h)
    rew, qf, qdf = run(q0, qd0, acts, dyn=s0.frame)
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    torch.cuda.synchronize()
    CHECKED[name] = dict(s0=s0, q0=q0, qd0=qd0, acts=acts, h_frame=hf,
                         s1=env.reset(torch.Generator(dev).manual_seed(2),
                                      dev),
                         out=(rew, qf, qdf), plain=(rew_p, qf_p, qdf_p))
    errs = {"rewards": rel_err(rew, rew_p), "qf": rel_err(qf, qf_p),
            "qdf": rel_err(qdf, qdf_p)}
    max_abs = max(float((a - b).abs().max())
                  for a, b in ((rew, rew_p), (qf, qf_p), (qdf, qdf_p)))
    check(max(errs.values()) <= TOL, f"{name}: kernel vs plain {errs} > {TOL}")

    # the bolt: held at its depth where the latch is up, passed where it is
    # pressed below the unlock angle
    door, latch = env.scalar_dyn_body, env._latch
    held = qf_p[:, door] == env.bolt_depth
    passed = (qf_p[:, door] > env.bolt_depth) & (
        q0[:, latch] < env.latch_unlock_angle)
    clamp = {"held": int(held.sum()), "passed": int(passed.sum())}
    check(clamp["held"] > 0 and clamp["passed"] > 0
          and bool(torch.equal(qf[:, door] == env.bolt_depth, held)),
          f"{name}: the clamp must hold some lanes and not others {clamp}")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, dyn=s0.frame)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          f"{name}: a NaN lane must go NaN alone")

    # the objective from the reset state: the mask, and a second frame
    a = acts[:, :hf].contiguous()
    mask = (torch.arange(hf, device=dev) < max(hf - 2, 1)).float()
    c_k = rk.kernel_mpc_objective(env, s0, hf, mask)(None, a)
    c_full = rk.kernel_mpc_objective(env, s0, hf)(None, a)
    q_r, qd_r = lanes(s0, N_CHECK)
    r_p = rk.env_plain_rollout(env, s0, q_r, qd_r, a)[0]
    errs["masked_costs"] = rel_err(c_k, -(r_p * mask).sum(1))
    check(errs["masked_costs"] <= TOL and not bool(torch.allclose(c_k, c_full)),
          f"{name}: horizon mask {errs['masked_costs']}")
    s1 = env.reset(torch.Generator(dev).manual_seed(2), dev)
    check(not bool(torch.equal(s1.frame, s0.frame)), f"{name}: frame not "
          "sampled")
    c_k1 = rk.kernel_mpc_objective(env, s1, hf)(None, a)
    r_p1 = rk.env_plain_rollout(env, s1, q_r, qd_r, a)[0]
    errs["second_frame_costs"] = rel_err(c_k1, -r_p1.sum(1))
    check(errs["second_frame_costs"] <= TOL
          and not bool(torch.allclose(c_k1, c_full)),
          f"{name}: second frame {errs['second_frame_costs']}")

    # the real step: one launch at N=1, H=1 against the eager step
    action = acts[N_CHECK // 2, 0]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    errs["real_step"] = max(rel_err(s_k.physics.qpos, s_e.physics.qpos),
                            rel_err(s_k.physics.qvel, s_e.physics.qvel),
                            rel_err(r_k, r_e))
    check(errs["real_step"] <= TOL, f"{name}: real step {errs['real_step']}")
    return errs, max_abs, clamp


def time_hand(name, env, dev):
    """Phase 15 for one env."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    out = {}
    h = HAND[name]["h_time"]
    s0 = env.reset(torch.Generator(dev).manual_seed(0), dev)
    for n, iters in ((64, 20), (1024, 5)):
        _, qn, qdn, a = hand_lanes(env, dev, n, h)
        r = rk.env_rollout(env, s0, h)
        out[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
            lambda: r(qn, qdn, a, dyn=s0.frame), iters)
    out[f"bound_ms_N64_H{h}"], out["bound_by"] = rollout_bound(env, 64, h)
    hp = HAND[name]["h_plain"]
    _, qn, qdn, a = hand_lanes(env, dev, 64, hp)
    if hp != h:   # the kernel at the plain rollout's shape too
        r = rk.env_rollout(env, s0, hp)
        out[f"kernel_ms_N64_H{hp}"] = cuda_ms(
            lambda: r(qn, qdn, a, dyn=s0.frame), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.env_plain_rollout(env, s0, qn, qdn, a)
    torch.cuda.synchronize()
    out[f"plain_ms_N64_H{hp}"] = 1e3 * (time.perf_counter() - t0)

    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(30),
        env.action_dim, mean, cov_in, cov_out, lengthscale=0.08,
        lower=env.action_low, upper=env.action_high, device=dev)
    step = _one_iteration(make_solver("Lbps", delta=0.9), family,
                          rk.kernel_mpc_objective(env, s0, 30), 64)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, (stats, _, _) = step(state, gen)
        torch.cuda.synchronize()
    out["ppi_iter_ms_N64_H30"] = 1e3 * (time.perf_counter() - t0) / 10
    check(bool(torch.isfinite(stats["mean"])),
          f"{name}: PPI iteration cost not finite")

    action = family.predict_mean(state)[0]
    for label, fn, iters in (("kernel_step_ms", env.step, 20),
                             ("eager_step_ms", env.plain_step, 1)):
        fn(s0, action)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            s1, _ = fn(s0, action)
        torch.cuda.synchronize()
        out[label] = 1e3 * (time.perf_counter() - t0) / iters
        check(bool(torch.isfinite(s1.physics.qpos).all()),
              f"{name}: real env step not finite")
    # the episode's other per-step host cost: the eager observation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        env.observe(s1)
    torch.cuda.synchronize()
    out["observe_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    return out


def scene_state(env, name, dev, index=0):
    """Phase 18's initial state: its second board or goal with ``index``
    1. hammer-v0's first board puts the nail just under the head's reset
    position, so that arms swinging down drive it; hammer-v0-hand's boards
    are sampled; the goals are pen-v0's and relocate-v0's pinned ones."""
    if name == "hammer-v0":
        if index:
            return env.reset(torch.Generator(dev).manual_seed(1), dev)
        s = env.reset(None, dev, board=(0.0, 0.0, 0.0))
        head, nail = env._sites(s.physics.qpos, s.board)
        drop = torch.tensor([0.0, 0.0, 0.065], device=dev)
        return env.reset(None, dev, board=head - nail - drop)
    if name == "hammer-v0-hand":
        return env.reset(torch.Generator(dev).manual_seed(1 + index), dev)
    base = name.replace("-hand", "")
    goal = VARIANT_B[base]["goals"][index]
    if base == "pen-v0":
        from ppi_tpu_torch.envs.pen import axis_from_angles
        goal = axis_from_angles(*goal)
        return env.reset(None, dev, goal=goal)
    return env.reset(None, dev, goal=goal, start=(0.02, -0.03))


def scene_lanes(env, name, dev, n, h, seed=1):
    """Phase 18's lanes: the state's posture in every lane and actions
    about it (``scale`` x z). In the second half of hammer-v0-hand's lanes
    the free hammer starts with its head over the nail, falling at 2 m/s
    (the strike contact and the nail's friction clip)."""
    cfg = SCENES[name]
    s0 = scene_state(env, name, dev)
    q0, qd0 = (x.clone() for x in lanes(s0, n))
    if name == "hammer-v0-hand":
        from ppi_tpu_torch.envs import hammer_hand as hh
        top = s0.board[2] + 0.06 + 0.018 + 0.045 + 0.01   # head centre z
        q0[n // 2:, hh.HAM_X] = hh.NAIL_X - hh.HEAD_LOCAL[0] \
            - hh.GRIP_START[0]
        q0[n // 2:, hh.HAM_Z] = top - hh.HEAD_LOCAL[2] - hh.GRIP_START[1]
        qd0[n // 2:, hh.HAM_Z] = -2.0
    rng = np.random.default_rng(seed)
    acts = q0[:, None, :env.action_dim] + torch.from_numpy(
        (cfg["scale"] * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(dev)
    return s0, q0, qd0, acts


def adroit_state(env, name, dev, index=0):
    """Phase 26's initial state: pen-v0's and relocate-v0's pinned goals, a
    sampled board for hammer-v0-adroit; ``index`` 1 the second. The
    relocate ball starts 0.1 m up beside the fingers, where it falls clear
    of the hand and above the lift gate for H=3, so the goal enters every
    lane's reward."""
    from ppi_tpu_torch.envs.physics.engine import PhysicsState
    if name == "hammer-v0-adroit":
        return env.reset(torch.Generator(dev).manual_seed(1 + index), dev)
    goal = VARIANT_B[name.replace("-adroit", "")]["goals"][index]
    if name == "pen-v0-adroit":
        from ppi_tpu_torch.envs.pen import axis_from_angles
        return env.reset(None, dev, goal=axis_from_angles(*goal))
    from ppi_tpu_torch.envs.relocate_adroit import BALL_Z
    s = env.reset(None, dev, goal=goal, start=(0.02, 0.2))
    qpos = s.physics.qpos.clone()
    qpos[BALL_Z] = 0.1
    return dataclasses.replace(s, physics=PhysicsState(
        qpos=qpos, qvel=s.physics.qvel))


def adroit_lanes(env, name, dev, n, h, seed=1):
    """Phase 26's lanes: the state's posture in every lane and PD targets
    about the actuated joints' posture (``scale`` x z). The second half of
    pen-v0-adroit's lanes starts with the pen 2 cm low, on the four
    fingers' proximal spheres; in the second half of hammer-v0-adroit's
    the free hammer starts with its head over the nail, falling at 2 m/s;
    in the first half of relocate-v0-adroit's the ball rests on the table
    under the open hand, where only the digits move it sideways."""
    cfg = ADROIT[name]
    s0 = adroit_state(env, name, dev)
    q0, qd0 = (x.clone() for x in lanes(s0, n))
    if name == "pen-v0-adroit":
        from ppi_tpu_torch.envs.pen_adroit import PEN_Z
        q0[n // 2:, PEN_Z] = -0.02
    if name == "relocate-v0-adroit":
        from ppi_tpu_torch.envs.relocate_adroit import BALL_Y, BALL_Z
        q0[:n // 2, BALL_Y], q0[:n // 2, BALL_Z] = -0.03, 0.0
    if name == "hammer-v0-adroit":
        from ppi_tpu_torch.envs import hammer_hand as hh
        from ppi_tpu_torch.envs.hammer_adroit import HAM_X, HAM_Z
        top = s0.board[2] + 0.06 + 0.018 + 0.045 + 0.01   # head centre z
        q0[n // 2:, HAM_X] = hh.NAIL_X - hh.HEAD_LOCAL[0] - hh.GRIP_START[0]
        q0[n // 2:, HAM_Z] = top - hh.HEAD_LOCAL[2] - hh.GRIP_START[1]
        qd0[n // 2:, HAM_Z] = -2.0
    a0 = cfg["act0"]
    rng = np.random.default_rng(seed)
    acts = q0[:, None, a0:a0 + env.action_dim] + torch.from_numpy(
        (cfg["scale"] * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(dev)
    return s0, q0, qd0, acts


def check_scene(name, env, dev, table=None, lanes_fn=None, state_fn=None):
    """Phase 18 (and 26) for one env: (errors, max abs error, lanes that
    moved the object). ``table``, ``lanes_fn`` and ``state_fn`` are the
    phase's config, lanes and states (phase 18's by default); the mask
    runs at the config's ``h_frame``, the second board or goal at its
    ``h_second`` (``h_frame`` unless given)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    table = SCENES if table is None else table
    lanes_fn = scene_lanes if lanes_fn is None else lanes_fn
    state_fn = scene_state if state_fn is None else state_fn
    cfg = table[name]
    h, h_frame = cfg["h_check"], cfg.get("h_frame", H_FRAME)
    s0, q0, qd0, acts = lanes_fn(env, name, dev, N_CHECK, h)
    consts, _, dyn = rk.kernel_operands(env, s0)
    run = rk.env_rollout(env, s0, h)
    rew, qf, qdf = run(q0, qd0, acts, consts=consts, dyn=dyn)
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    torch.cuda.synchronize()
    CHECKED[name] = dict(s0=s0, q0=q0, qd0=qd0, acts=acts, h_frame=h_frame,
                         s1=state_fn(env, name, dev, 1), out=(rew, qf, qdf),
                         plain=(rew_p, qf_p, qdf_p))
    errs = {"rewards": rel_err(rew, rew_p), "qf": rel_err(qf, qf_p),
            "qdf": rel_err(qdf, qdf_p)}
    max_abs = max(float((a - b).abs().max())
                  for a, b in ((rew, rew_p), (qf, qf_p), (qdf, qdf_p)))
    check(bool(torch.isfinite(rew_p).all()), f"{name}: plain rewards not "
          "finite")
    check(max(errs.values()) <= SCENE_TOL,
          f"{name}: kernel vs plain {errs} > {SCENE_TOL}")
    errs["bit_identical"] = bool(torch.equal(rew, rew_p)
                                 and torch.equal(qf, qf_p)
                                 and torch.equal(qdf, qdf_p))
    idx = list(cfg["moved"])
    moved = int(((qf_p[:, idx] - q0[:, idx]).abs().amax(1) > 1e-3).sum())
    check(moved > 0, f"{name}: no lane moved coordinates {idx}: the check "
          "exercises no contact")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, consts=consts, dyn=dyn)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          f"{name}: a NaN lane must go NaN alone")

    # the objective from the state: the mask, and a second board or goal
    a = acts[:, :h_frame].contiguous()
    mask = (torch.arange(h_frame, device=dev) < max(h_frame - 2, 1)).float()
    c_k = rk.kernel_mpc_objective(env, s0, h_frame, mask)(None, a)
    c_full = rk.kernel_mpc_objective(env, s0, h_frame)(None, a)
    q_r, qd_r = lanes(s0, N_CHECK)
    r_p = rk.env_plain_rollout(env, s0, q_r, qd_r, a)[0]
    errs["masked_costs"] = rel_err(c_k, -(r_p * mask).sum(1))
    check(errs["masked_costs"] <= SCENE_TOL
          and not bool(torch.allclose(c_k, c_full)),
          f"{name}: horizon mask {errs['masked_costs']}")
    # the second board or goal at the config's h_second (h_frame unless
    # given)
    h2 = cfg.get("h_second", h_frame)
    a2 = acts[:, :h2].contiguous()
    c_full2 = c_full if h2 == h_frame else rk.kernel_mpc_objective(
        env, s0, h2)(None, a2)
    s1 = state_fn(env, name, dev, 1)
    c_k1 = rk.kernel_mpc_objective(env, s1, h2)(None, a2)
    q_1, qd_1 = lanes(s1, N_CHECK)
    r_p1 = rk.env_plain_rollout(env, s1, q_1, qd_1, a2)[0]
    errs["second_costs"] = rel_err(c_k1, -r_p1.sum(1))
    check(errs["second_costs"] <= SCENE_TOL
          and not bool(torch.allclose(c_k1, c_full2)),
          f"{name}: second board or goal {errs['second_costs']}, or it "
          "changes no cost")

    # the real step: one launch at N=1, H=1 against the eager step
    action = acts[N_CHECK // 2, 0]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    errs["real_step"] = max(rel_err(s_k.physics.qpos, s_e.physics.qpos),
                            rel_err(s_k.physics.qvel, s_e.physics.qvel),
                            rel_err(r_k, r_e))
    check(errs["real_step"] <= SCENE_TOL and int(s_k.t) == 1,
          f"{name}: real step {errs['real_step']}")
    return errs, max_abs, moved


def time_scene(name, env, dev, table=None, lanes_fn=None):
    """Phase 19 (and 27) for one env; the plain rollout at the config's
    ``plain_shape`` (the canonical N at H_PLAIN by default), the eager
    real step unless ``eager_step`` is false."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    table = SCENES if table is None else table
    lanes_fn = scene_lanes if lanes_fn is None else lanes_fn
    cfg = table[name]
    n, h = cfg["shape"]
    out = {"ops_per_lane_step": rk.ops_per_lane_step(*rk.body_args(
        env, env.reset(torch.Generator().manual_seed(0), "cpu")))}
    s0, qn, qdn, a = lanes_fn(env, name, dev, n, h)
    consts, _, dyn = rk.kernel_operands(env, s0)
    r = rk.env_rollout(env, s0, h)
    out[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
        lambda: r(qn, qdn, a, consts=consts, dyn=dyn), 20)
    out[f"bound_ms_N{n}_H{h}"], out["bound_by"] = rollout_bound(env, n, h)
    pn, ph = cfg.get("plain_shape", (n, H_PLAIN))
    if (pn, ph) != (n, h):   # the kernel at the plain rollout's shape too
        r2, a2 = rk.env_rollout(env, s0, ph), a[:pn, :ph].contiguous()
        out[f"kernel_ms_N{pn}_H{ph}"] = cuda_ms(
            lambda: r2(qn[:pn], qdn[:pn], a2, consts=consts, dyn=dyn), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.env_plain_rollout(env, s0, qn[:pn], qdn[:pn], a[:pn, :ph])
    torch.cuda.synchronize()
    out[f"plain_ms_N{pn}_H{ph}"] = 1e3 * (time.perf_counter() - t0)

    alg, policy, kwargs = cfg["family"]
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        policy, env.dt * torch.arange(h), env.action_dim, mean, cov_in,
        cov_out, lower=env.action_low, upper=env.action_high, device=dev,
        **kwargs)
    step = _one_iteration(
        make_solver(alg, delta=0.9, alpha=10.0, n_elites=10,
                    dimension=family.dim_features), family,
        rk.kernel_mpc_objective(env, s0, h), n)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, (stats, _, _) = step(state, gen)
        torch.cuda.synchronize()
    out[f"ppi_iter_ms_N{n}_H{h}"] = 1e3 * (time.perf_counter() - t0) / 10
    check(bool(torch.isfinite(stats["mean"])),
          f"{name}: PPI iteration cost not finite")

    action = family.predict_mean(state)[0]
    steps = [("kernel_step_ms", env.step, 20)]
    if cfg.get("eager_step", True):
        steps.append(("eager_step_ms", env.plain_step, 1))
    for label, fn, iters in steps:
        fn(s0, action)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            s1, _ = fn(s0, action)
        torch.cuda.synchronize()
        out[label] = 1e3 * (time.perf_counter() - t0) / iters
        check(bool(torch.isfinite(s1.physics.qpos).all()),
              f"{name}: real env step not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        env.observe(s1)
    torch.cuda.synchronize()
    out["observe_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    return out


def rest_state(env, name, dev, second=False):
    """Phase 22's initial state: a reset at seed 0 (the locomotion envs and
    reacher), or a contact start; with ``second`` the second target or
    goal pinned instead of the sampled one, or where the env has none the
    reset at seed 1 (a second start; finger~spin's not pinned to the
    contact pose, which would be the first start again)."""
    from ppi_tpu_torch.envs.physics.engine import PhysicsState
    pin = REST[name]["second"] if second else None
    gen = torch.Generator(dev).manual_seed(
        1 if second and pin is None else 0)
    if name == "reacher":
        return env.reset(gen, dev, target=pin)
    if name == "fetch-push":
        return env.reset(gen, dev, target=pin, start=PUSH_CONTACT_START)
    if name == "fetch-pick":
        return env.reset(gen, dev, target=pin, start=PICK_CONTACT_START)
    s = env.reset(gen, dev)
    if name == "finger~spin" and not second:
        s = dataclasses.replace(s, physics=PhysicsState(
            qpos=torch.tensor(FINGER_CONTACT_Q, device=dev),
            qvel=torch.zeros(3, device=dev)))
    return s


def rest_actions(env, name, q0, n, h, seed=1):
    """Random actions of the check's scale: torques (x the box for the
    locomotion envs), or PD targets about the arm's posture."""
    scale = REST[name]["scale"]
    if name in ("hopper", "walker2d", "walker~walk", "humanoid-standup"):
        scale *= env.max_torque
    z = torch.from_numpy((scale * np.random.default_rng(seed).standard_normal(
        (n, h, env.action_dim))).astype(np.float32)).to(q0.device)
    if name in ("fetch-push", "fetch-pick"):
        return q0[:, None, :env.action_dim] + z
    return z


def check_rest(name, env, dev):
    """Phase 22 for one env: (errors, max abs error, lanes in contact)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.envs.physics.engine_soa import make_sites_soa
    cfg = REST[name]
    s0 = rest_state(env, name, dev)
    q0, qd0 = lanes(s0, N_CHECK)
    acts = rest_actions(env, name, q0, N_CHECK, H_EAGER)
    consts, _, _ = rk.kernel_operands(env, s0)
    run = rk.env_rollout(env, s0, H_EAGER)
    rew, qf, qdf = run(q0, qd0, acts, consts=consts)
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    torch.cuda.synchronize()
    if name in WARP or name in SPLIT:   # phase 33's or 36's lanes
        CHECKED[name] = dict(s0=s0, q0=q0, qd0=qd0, acts=acts,
                             h_frame=H_FRAME,
                             s1=rest_state(env, name, dev, second=True),
                             out=(rew, qf, qdf), plain=(rew_p, qf_p, qdf_p))
    errs = {"rewards": rel_err(rew, rew_p), "qf": rel_err(qf, qf_p),
            "qdf": rel_err(qdf, qdf_p)}
    max_abs = max(float((a - b).abs().max())
                  for a, b in ((rew, rew_p), (qf, qf_p), (qdf, qdf_p)))
    check(bool(torch.isfinite(rew_p).all()), f"{name}: plain rewards not "
          "finite")
    check(max(errs.values()) <= TOL, f"{name}: kernel vs plain {errs} > {TOL}")
    errs["bit_identical"] = bool(torch.equal(rew, rew_p)
                                 and torch.equal(qf, qf_p)
                                 and torch.equal(qdf, qdf_p))

    # the lanes in contact: the object moved, or a foot ends on the ground
    contact = None
    if cfg["moved"] is not None:
        idx = list(cfg["moved"])
        contact = int(((qf_p[:, idx] - q0[:, idx]).abs().amax(1)
                       > 1e-3).sum())
    elif cfg["feet"] is not None:
        pts = make_sites_soa(env._model)(qf_p)
        radius = torch.tensor(env._model.sphere_radius, device=dev)
        bottom = pts[:, list(cfg["feet"]), 2] - radius[list(cfg["feet"])]
        contact = int((bottom.amin(1) < 0.0).sum())
    if contact is not None:
        check(contact > 0, f"{name}: no lane in contact: the check "
              "exercises no contact")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, consts=consts)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          f"{name}: a NaN lane must go NaN alone")

    # actions past the box: the torque (and a reward that clips) sees the
    # clipped action; reacher's control cost is on the raw action
    lo = env.action_low.to(dev)
    hi = env.action_high.to(dev)
    past = float(((acts < lo) | (acts > hi)).float().mean())
    rew_c, qf_c, qdf_c = run(q0, qd0, torch.maximum(torch.minimum(acts, hi),
                                                    lo), consts=consts)
    same_state = bool(torch.equal(qf_c, qf) and torch.equal(qdf_c, qdf))
    if name == "reacher":
        clipped = torch.maximum(torch.minimum(acts, hi), lo)
        extra = 0.01 * ((acts * acts).sum(-1) - (clipped * clipped).sum(-1))
        same_reward = bool(torch.allclose(rew_c - rew, extra, rtol=1e-4,
                                          atol=1e-6))
    else:
        same_reward = bool(torch.equal(rew_c, rew))
    check(past > 0.02 and same_state and same_reward,
          f"{name}: actions past the box ({past:.3f} of them) change the "
          "result of the clip")
    errs["past_box_share"] = past

    # the objective from the state: the mask, and a second target or goal
    a = acts[:, :H_FRAME].contiguous()
    mask = (torch.arange(H_FRAME, device=dev) < H_FRAME - 2).float()
    c_k = rk.kernel_mpc_objective(env, s0, H_FRAME, mask)(None, a)
    c_full = rk.kernel_mpc_objective(env, s0, H_FRAME)(None, a)
    r_p = rew_p[:, :H_FRAME]   # the plain rollout's: same lanes and actions
    errs["masked_costs"] = rel_err(c_k, -(r_p * mask).sum(1))
    check(errs["masked_costs"] <= TOL
          and not bool(torch.allclose(c_k, c_full)),
          f"{name}: horizon mask {errs['masked_costs']}")
    if cfg["second"] is not None:
        s1 = rest_state(env, name, dev, second=True)
        c_k1 = rk.kernel_mpc_objective(env, s1, H_FRAME)(None, a)
        r_p1 = rk.env_plain_rollout(env, s1, q0, qd0, a)[0]
        errs["second_costs"] = rel_err(c_k1, -r_p1.sum(1))
        check(errs["second_costs"] <= TOL
              and float((c_k1 - c_full).abs().min()) > 1e-4,
              f"{name}: second target or goal {errs['second_costs']}, or "
              "it does not change every cost")

    # the real step: one launch at N=1, H=1 against the eager step
    action = acts[N_CHECK // 2, 0]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    errs["real_step"] = max(rel_err(s_k.physics.qpos, s_e.physics.qpos),
                            rel_err(s_k.physics.qvel, s_e.physics.qvel),
                            rel_err(r_k, r_e))
    check(errs["real_step"] <= TOL and int(s_k.t) == 1,
          f"{name}: real step {errs['real_step']}")
    return errs, max_abs, contact


def time_rest(name, env, dev):
    """Phase 23 for one env."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    cfg = REST[name]
    n, h = cfg["shape"]
    s0 = rest_state(env, name, dev)
    out = {"ops_per_lane_step": rk.ops_per_lane_step(*rk.body_args(env, s0))}
    qn, qdn = lanes(s0, n)
    a = rest_actions(env, name, qn, n, h, seed=3)
    consts, _, _ = rk.kernel_operands(env, s0)
    r = rk.env_rollout(env, s0, h)
    out[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
        lambda: r(qn, qdn, a, consts=consts), 20)
    out[f"bound_ms_N{n}_H{h}"], out["bound_by"] = rollout_bound(env, n, h)
    ap = a[:, :H_PLAIN].contiguous()   # the plain rollout's shape
    rp = rk.env_rollout(env, s0, H_PLAIN)
    out[f"kernel_ms_N{n}_H{H_PLAIN}"] = cuda_ms(
        lambda: rp(qn, qdn, ap, consts=consts), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.env_plain_rollout(env, s0, qn, qdn, ap)
    torch.cuda.synchronize()
    out[f"plain_ms_N{n}_H{H_PLAIN}"] = 1e3 * (time.perf_counter() - t0)

    alg, policy, kwargs, alpha = cfg["family"]
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        policy, env.dt * torch.arange(h), env.action_dim, mean, cov_in,
        cov_out, lower=env.action_low, upper=env.action_high, device=dev,
        **kwargs)
    step = _one_iteration(make_solver(alg, alpha=alpha), family,
                          rk.kernel_mpc_objective(env, s0, h), n)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, (stats, _, _) = step(state, gen)
        torch.cuda.synchronize()
    out[f"ppi_iter_ms_N{n}_H{h}"] = 1e3 * (time.perf_counter() - t0) / 10
    check(bool(torch.isfinite(stats["mean"])),
          f"{name}: PPI iteration cost not finite")

    action = family.predict_mean(state)[0]
    env.step(s0, action)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        s1, _ = env.step(s0, action)
    torch.cuda.synchronize()
    out["kernel_step_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    check(bool(torch.isfinite(s1.physics.qpos).all()),
          f"{name}: real env step not finite")
    env.observe(s1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        env.observe(s1)
    torch.cuda.synchronize()
    out["observe_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    return out


def rest_gate(name, env, ret, success, state, timesteps):
    """(passed, what is reported) of phase 24's episode gate, from the
    episode's return, success and final state."""
    if name == "reacher":
        tip = env.fingertip(state.physics.qpos)
        dist = float(torch.linalg.norm(tip - state.target))
        return dist < 0.08, {"fingertip_to_target": dist}
    if name in ("finger~spin", "walker~walk"):
        per_step = ret / timesteps
        return per_step >= (0.5 if name == "finger~spin" else 0.3), {
            "reward_per_step": per_step}
    if name in ("fetch-push", "fetch-pick"):
        return bool(success), {}
    if name == "humanoid-standup":
        head = float(env.head_height(state.physics.qpos))
        return np.isfinite(ret) and ret > STANDUP_LYING, {"head_height": head}
    return np.isfinite(ret) and ret > 0.0, {}


def run_episode(args_list, n_samples, seed=0, final=None, key="rollout"):
    """One episode through the port's run_mpc; (return, success, wall s,
    kernel launches). ``final(env_state, row)`` sees the last control
    step. ``key`` is the layout's launch counter (``rk.LAUNCH_KEYS``): the
    episode must launch the other layout's kernel no time."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.runners import run_mpc
    args = run_mpc.build_parser().parse_args(
        args_list + ["--n-warmstart-iters", "50", "--seed", str(seed),
                     "--device", "cuda", "MonteCarlo", "--n-samples",
                     str(n_samples)])
    callback = None
    if final is not None:
        def callback(t, env_state, row):
            if t == args.timesteps - 1:
                final(env_state, row)
            return False
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(args, callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(track["action"]).all()),
          f"{args.env}: episode actions not finite")
    other = sum(v for k, v in LAUNCHES.items()
                if k.startswith("rollout") and k != key)
    check(other == 0, f"{args.env}: {other} launches of the other layout")
    return ret, success, wall, LAUNCHES[key]


def same_bits(a, b):
    """Bit-identical float32 tensors (NaN lanes included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def same_rewards(a, b, exact):
    """Rewards bit for bit, or (``exact`` false) of one shape, NaN at the
    same places and every other value within SCENE_TOL of ``b``."""
    if exact:
        return same_bits(a, b)
    nan = torch.isnan(a)
    if a.shape != b.shape or not torch.equal(nan, torch.isnan(b)):
        return False
    return bool(nan.all()) or rel_err(a[~nan], b[~nan]) <= SCENE_TOL


def time_ppi(door, s0, objective, n, horizon, iters):
    """ms per synced PPI iteration (sample -> rollout -> LBPS update) with
    the SE prior (lengthscale 4 dt) and ``objective`` on ``s0``'s device;
    returns (ms, last stats)."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.policies import design_moments, make_policy
    dev = s0.physics.qpos.device
    mean, cov_in, cov_out = design_moments(door.action_low, door.action_high,
                                           ratio=1000.0)
    family, policy = make_policy(
        "SquaredExponentialKernel", door.dt * torch.arange(horizon),
        door.action_dim, mean, cov_in, cov_out, lengthscale=4 * door.dt,
        lower=door.action_low, upper=door.action_high, device=dev)
    step = _one_iteration(make_solver("Lbps", delta=0.9), family, objective,
                          n)
    gen = torch.Generator(dev).manual_seed(0)
    state = policy
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters, stats


def plain_sharded_costs(door, s0, mesh, acts, mask=None):
    """The plain version of the sharded kernel objective: this rank's shard
    through the eager rollout, gathered as the kernel objective gathers."""
    from ppi_tpu_torch.envs.base import risk_aggregate
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.parallel import gather_costs, shard_bounds
    n = acts.shape[0]
    lo, hi = shard_bounds(n, mesh)
    rew = rk.env_plain_rollout(door, s0, *lanes(s0, hi - lo), acts[lo:hi])[0]
    return gather_costs(risk_aggregate(rew, mask), n, mesh)


def mesh_phases(rank, cfg):
    """Phases 29-31 on one rank of a spawned group
    (``ppi_tpu_torch.parallel.spawn``); rank 0 returns what the parent
    checks and prints. ``cfg``: the check's actions and mask, the episodes'
    runner arguments, and whether to run phase 31 (the 4-rank group) or
    phases 29-30 only (the 1-rank nccl group)."""
    import torch.distributed as dist
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.parallel import (
        make_mesh, make_multislice_mesh, shard_bounds)
    from ppi_tpu_torch.parallel.mesh import per_rank, replicas_agree
    from ppi_tpu_torch.runners import run_mpc
    from ppi_tpu_torch.runners.run_mpc import ENVS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device=cfg["device"])
    dev, w = mesh.device, mesh.size()
    door = Door(fixed_scene=True)
    s0 = door.reset(None, dev)
    out = {"backend": mesh.backend, "ranks": w}

    # ---- 29. the sharded objective against the unsharded one -------------
    acts = torch.from_numpy(cfg["acts"]).to(dev)
    mask = torch.from_numpy(cfg["mask"]).to(dev)
    bad = acts.clone()
    bad[MESH_NAN_LANE, 0, 0] = torch.nan
    f = rk.sharded_kernel_mpc_objective(door, s0, H_CHECK, mesh)
    LAUNCHES.clear()
    costs, nan = f(None, acts), f(None, bad)
    masked = rk.sharded_kernel_mpc_objective(door, s0, H_CHECK, mesh,
                                             mask)(None, acts)
    launches = per_rank(LAUNCHES[rk.launch_key(door)], mesh)
    divide = None
    try:
        f(None, torch.cat([acts, acts[:2]]))
    except ValueError as e:
        divide = str(e)
    plain = plain_sharded_costs(door, s0, mesh, acts)
    out["check"] = dict(
        costs=costs.cpu(), nan=nan.cpu(), masked=masked.cpu(),
        plain=plain.cpu(), launches=launches, divide=divide,
        agree=replicas_agree([costs, nan, masked, plain], mesh))

    # the sharded objective on a warp-layout body (its board from the
    # parent's state), which launches the env's own layout on each shard
    env_w = ENVS[MESH_WARP]()
    s_w = env_w.reset(None, dev, board=torch.from_numpy(cfg["warp_board"]))
    LAUNCHES.clear()
    costs_w = rk.sharded_kernel_mpc_objective(env_w, s_w, H_MESH_WARP, mesh)(
        None, torch.from_numpy(cfg["warp_acts"]).to(dev))
    out["warp_check"] = dict(
        costs=costs_w.cpu(), agree=replicas_agree(costs_w, mesh),
        launches={lay: per_rank(LAUNCHES[key], mesh)
                  for lay, key in rk.LAUNCH_KEYS.items()})

    # ---- 30. timings at N=16384, H=160 ------------------------------------
    lo, hi = shard_bounds(N_MESH, mesh)
    dist.barrier()
    ppi_ms, stats = time_ppi(door, s0, rk.sharded_kernel_mpc_objective(
        door, s0, H_MESH, mesh), N_MESH, H_MESH, MESH_ITERS)
    a = 0.4 * torch.randn((hi - lo, H_MESH, door.action_dim), device=dev,
                          generator=torch.Generator(dev).manual_seed(rank))
    qn, qdn = lanes(s0, hi - lo)
    run_ = rk.env_rollout(door, s0, H_MESH)
    kernel_ms = 0.0
    for r in range(w):  # one rank at a time: the card to itself
        if r == rank:
            kernel_ms = cuda_ms(lambda: run_(qn, qdn, a, dyn=s0.frame), 10)
        dist.barrier()
    full = torch.zeros(N_MESH, device=dev)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(full, group=mesh.group())
    torch.cuda.synchronize()
    all_reduce_ms = 1e3 * (time.perf_counter() - t0) / 20
    a_plain = 0.4 * torch.randn((N_MESH, H_MESH_PLAIN, door.action_dim),
                                device=dev,
                                generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    plain_sharded_costs(door, s0, mesh, a_plain)
    torch.cuda.synchronize()
    out["timings"] = dict(
        ppi_iter_ms=ppi_ms, ppi_cost_finite=bool(torch.isfinite(
            stats["mean"])), kernel_ms=per_rank(kernel_ms, mesh),
        all_reduce_ms=all_reduce_ms,
        plain_ms=1e3 * (time.perf_counter() - t0))

    # ---- 31. episodes -------------------------------------------------------
    if cfg["episodes"]:
        ms = make_multislice_mesh(2, 2, device=cfg["device"])
        out["episodes"] = {}
        for key, args_list, m, axis in (
                ("mesh", cfg["episode"], mesh, "samples"),
                ("slices_samples", cfg["short"], ms, ("slices", "samples")),
                ("samples", cfg["short"], ms, "samples")):
            args = run_mpc.build_parser().parse_args(args_list)
            agent, carry, env_state = run_mpc.setup(args)
            agent = dataclasses.replace(agent, mesh=m, mesh_axis=axis)
            LAUNCHES.clear()
            dist.barrier()
            t0 = time.perf_counter()
            carry, _ = agent.warm_start(carry, env_state,
                                        args.n_warmstart_iters)
            carry, env_state, track = agent.run_episode(carry, env_state)
            torch.cuda.synchronize()
            out["episodes"][key] = dict(
                ret=float(track["reward"].sum()),
                success=bool(agent.env.success(env_state)),
                wall_s=time.perf_counter() - t0,
                launches=per_rank(LAUNCHES[rk.launch_key(door)], mesh),
                agree=replicas_agree([carry.policy, track["action"],
                                      env_state.physics.qpos], mesh))
    # the generic sharded objective: run_opt and run_policy_search over
    # this group, and goal_success's episodes split over it (only the
    # 4-rank group)
    if cfg.get("opt"):
        out.update(sharded_runs(mesh, cfg))
    if cfg.get("goals"):
        out["goals"] = goal_sweep(cfg["goals"], mesh)
    return out if rank == 0 else None


def goal_sweep(goals, mesh=None):
    """Phase 31's goal sweep (``MESH_GOALS``) through goal_success, its
    episodes split over ``mesh`` (in its group) or all in this process:
    the episodes, the launches of pen-v0's routed layout (each rank's) and
    the wall time."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.parallel.mesh import per_rank
    from ppi_tpu_torch.runners import goal_success
    from ppi_tpu_torch.runners.run_mpc import ENVS
    key = rk.launch_key(ENVS[goals["env"]]())
    LAUNCHES.clear()
    t0 = time.perf_counter()
    summary = goal_success.run(
        goals["env"], goals["resets"],
        overrides=dict(timesteps=goals["timesteps"]),
        mesh_devices=0 if mesh is None else mesh.size(), device="cuda")
    torch.cuda.synchronize()
    return dict(episodes=summary["episodes"],
                launches=(LAUNCHES[key] if mesh is None
                          else per_rank(LAUNCHES[key], mesh)),
                wall_s=time.perf_counter() - t0)


def sharded_runs(mesh, cfg):
    """Phase 31's run_opt and run_policy_search on this rank of ``mesh``
    (``parallel.sharded_objective``): the final state, the trace, the
    generator's state and each rank's kernel launches (moment match, ball
    in a cup)."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    from ppi_tpu_torch.parallel.mesh import per_rank, replicas_agree
    from ppi_tpu_torch.runners import run_opt, run_policy_search as rps
    import torch.distributed as dist
    out = {}
    LAUNCHES.clear()
    dist.barrier()
    t0 = time.perf_counter()
    state, trace, gen = run_opt.optimize(
        run_opt.build_parser().parse_args(cfg["opt"]), mesh)
    torch.cuda.synchronize()
    out["opt"] = dict(
        state=run_state(state), trace={k: v.cpu() for k, v in trace.items()},
        generator=gen.get_state(), wall_s=time.perf_counter() - t0,
        launches=per_rank(LAUNCHES["moment_match"], mesh),
        agree=replicas_agree(state, mesh))
    LAUNCHES.clear()
    dist.barrier()
    t0 = time.perf_counter()
    policy, trace, gen, _ = rps.search(
        rps.build_parser().parse_args(cfg["search"]), mesh)
    torch.cuda.synchronize()
    out["search"] = dict(
        state=run_state(policy), trace={k: v.cpu() for k, v in trace.items()},
        generator=gen.get_state(), wall_s=time.perf_counter() - t0,
        launches=per_rank(LAUNCHES[bk.LAUNCH_KEYS[bk.route(BallInCupSim())]],
                          mesh),
        agree=replicas_agree(policy, mesh))
    return out


def run_state(state):
    """A policy state's tensors, on the host, by field."""
    return {f.name: getattr(state, f.name).cpu()
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def check_sharded_runs(res, refs):
    """Phase 31's sharded run_opt and run_policy_search against the
    unsharded runs of the parent (``refs``): bit for bit in the final
    state, every stat of the trace and the generator's state, with the
    kernels' launches a rank."""
    from ppi_tpu_torch.parallel.mesh import _bits
    w = res["ranks"]
    for key, kernel, want in (("opt", "moment_match", 10),
                              ("search", "bic_rollout", 3)):
        got, ref = res[key], refs[key]
        tag = f"sharded {key} ({w} ranks)"
        check(got["agree"], f"{tag}: the ranks' states differ")
        check(got["launches"] == [float(want)] * w,
              f"{tag}: {kernel} launches per rank {got['launches']}, "
              f"expected {want}")
        check(torch.equal(got["generator"], ref["generator"]),
              f"{tag}: generator state differs from unsharded")
        check(sorted(got["trace"]) == sorted(ref["trace"]),
              f"{tag}: trace keys")
        for part in ("trace", "state"):
            for k, v in ref[part].items():
                check(torch.equal(_bits(got[part][k]), _bits(v)),
                      f"{tag}: {part} {k} differs from unsharded")
        print(f"check sharded {key} ({w} ranks, gloo, one card): final "
              f"state, trace ({', '.join(sorted(ref['trace']))}) and "
              f"generator state bit-identical to the unsharded run; "
              f"{kernel} launches per rank {got['launches']}; wall "
              f"{got['wall_s']:.2f} s (unsharded {ref['wall_s']:.2f} s)",
              flush=True)


def unsharded_runs():
    """The unsharded references of phase 31's sharded runs, in this
    process (which built both kernels)."""
    from ppi_tpu_torch.runners import run_opt, run_policy_search as rps
    refs = {}
    for key, argv, fn in (("opt", MESH_OPT, run_opt.optimize),
                          ("search", MESH_SEARCH, rps.search)):
        args = (run_opt if key == "opt" else rps).build_parser().parse_args(
            argv)
        args.mesh_devices = 0
        t0 = time.perf_counter()
        state, trace, gen = fn(args)[:3]
        torch.cuda.synchronize()
        refs[key] = dict(state=run_state(state),
                         trace={k: v.cpu() for k, v in trace.items()},
                         generator=gen.get_state(),
                         wall_s=time.perf_counter() - t0)
    return refs


def bic_actions(n, horizon, seed, dev):
    """(N, T, 4) setpoints about the canonical start: the shoulder and
    the elbow's positions, held over the trajectory, and their
    velocities. Over the check's 40 steps no lane catches the ball or
    hits the arm: ``catch_actions`` takes those branches."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, horizon, 4), np.float32)
    a[..., 0] = BIC_Q_START[1] + 0.4 * rng.standard_normal((n, 1))
    a[..., 1] = BIC_Q_START[3] + 0.4 * rng.standard_normal((n, 1))
    a[..., 2:] = 3.0 * rng.standard_normal((n, horizon, 2))
    return torch.from_numpy(a).to(dev)


def catch_actions(n, horizon, seed, dev):
    """(N, T, 4) setpoints that hold the shoulder and the elbow at a
    position drawn from BIC_CATCH_RANGE, at rest: the elbow raised past
    the canonical start's, so that within 60 steps a few lanes catch the
    ball and others hit the arm with it."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, horizon, 4), np.float32)
    for k, (lo, hi) in enumerate(BIC_CATCH_RANGE):
        a[..., k] = rng.uniform(lo, hi, (n, 1))
    return torch.from_numpy(a).to(dev)


def bic_errors(sim, got, plain):
    """(errors by group, max abs of the reward) of the kernel's outputs
    against the plain version's, NaN lanes aside (which must match)."""
    st, r, ok = got
    pst, pr, pok = plain
    L = sim.layout
    check(torch.equal(torch.isnan(st), torch.isnan(pst))
          and torch.equal(torch.isnan(r), torch.isnan(pr)),
          "ball-in-a-cup: NaN lanes differ from plain")
    a, b = st.double().nan_to_num(0.0), pst.double().nan_to_num(0.0)
    rel = (a - b).abs() / (1.0 + b.abs())
    rr, pp = r.double().nan_to_num(0.0), pr.double().nan_to_num(0.0)
    errs = {"state": float(rel[:, :L.FORCE].max()),
            "stats": float(rel[:, L.MAX_POT:].max()),
            "reaction_abs": float((a - b)[:, L.FORCE:L.MAX_POT].abs().max()),
            "reward": float(((rr - pp).abs() / (1.0 + pp.abs())).max())}
    check(errs["state"] <= BIC_TOL and errs["reward"] <= BIC_TOL
          and errs["stats"] <= BIC_STATS_TOL
          and errs["reaction_abs"] <= BIC_REACTION_ATOL,
          f"ball-in-a-cup kernel vs plain {errs}")
    check(torch.equal(ok, pok), "ball-in-a-cup: success flags differ")
    check(torch.equal(st[:, L.VIOLATED], pst[:, L.VIOLATED]),
          "ball-in-a-cup: violation flags differ")
    return errs, float((rr - pp).abs().max())


def check_bic(dev):
    """Phase 39: the ball-in-a-cup kernel as routed against its plain
    version at N=1000 over BIC_PHASES steps, a NaN setpoint in one lane,
    and a padded launch whose sentinels past N must stay; the routed
    layout against the other bit for bit, NaN lane and all. Returns the
    numbers and the kernel's and the plain version's times at this
    shape."""
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    n_stab, horizon, n_cool = BIC_PHASES
    sim = BallInCupSim(stabilize_steps=n_stab, cooldown_steps=n_cool)
    acts = bic_actions(BIC_N_CHECK, horizon, 39, dev)
    acts[BIC_NAN_LANE, 3, 0] = float("nan")
    q = torch.tensor(BIC_Q_START, device=dev)
    run = bk.make_bic_rollout(sim)
    got = run(q, acts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bk.plain_bic_rollout(sim, q, acts)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    errs, max_abs = bic_errors(sim, got, plain)
    bad = torch.isnan(got[0]).any(1).nonzero().flatten().tolist()
    check(bad == [BIC_NAN_LANE], f"ball-in-a-cup: NaN lanes {bad}")
    other = "thread" if run.layout == "warp" else "warp"
    ref = bk.make_bic_rollout(sim, other)(q, acts)
    torch.cuda.synchronize()
    check(all(same_bits(x, y) for x, y in zip(got, ref)),
          f"ball-in-a-cup: the {run.layout} layout's bits differ from the "
          f"{other} layout's")
    # the launch itself into padded outputs (ragged: the last block
    # partly past N), against the wrapper's outputs
    fn = run.load()
    size = sim.layout.size
    act = acts.permute(1, 2, 0).contiguous()
    state = torch.full((size * BIC_N_CHECK + SENTINEL_PAD,), SENTINEL,
                       device=dev)
    score = torch.full((2 * BIC_N_CHECK + SENTINEL_PAD,), SENTINEL,
                       device=dev)
    err = fn(q.data_ptr(), act.data_ptr(), state.data_ptr(),
             score.data_ptr(), BIC_N_CHECK, horizon, n_stab, n_cool,
             BIC_PAD_BLOCK[run.layout],
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"ball-in-a-cup padded launch: CUDA error {err}")
    kept = bool((state[-SENTINEL_PAD:] == SENTINEL).all()
                and (score[-SENTINEL_PAD:] == SENTINEL).all())
    check(kept, "ball-in-a-cup: a lane past N was written")
    check(same_bits(state[:size * BIC_N_CHECK].view(size, BIC_N_CHECK).t(),
                    got[0])
          and same_bits(score[:2 * BIC_N_CHECK].view(2, BIC_N_CHECK)[0],
                        got[1]),
          "ball-in-a-cup: the padded launch differs from the wrapper's")
    kernel_ms = cuda_ms(lambda: run(q, acts), 5, warmup=1)
    return dict(layout=run.layout, errors=errs, max_abs_err=max_abs,
                nan_lanes=bad, sentinels_kept=kept,
                bits_equal_other_layout=True, other_layout=other,
                successes=int(got[2].sum()),
                violated=int((got[0][:, sim.layout.VIOLATED] != 0).sum()),
                plain_ms=plain_ms, kernel_ms=kernel_ms)


def check_bic_branches(dev):
    """Phase 39's branch check: the kernel as routed on BIC_BRANCH_N lanes
    of ``catch_actions`` over BIC_BRANCH_PHASES steps against the plain
    version on the CPU, the success and violation flags exactly; both
    branches must be taken and some lanes must take neither; the other
    layout's bits the same."""
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    n_stab, horizon, n_cool = BIC_BRANCH_PHASES
    sim = BallInCupSim(stabilize_steps=n_stab, cooldown_steps=n_cool)
    acts = catch_actions(BIC_BRANCH_N, horizon, 39, dev)
    q = torch.tensor(BIC_Q_START, device=dev)
    run = bk.make_bic_rollout(sim)
    got = run(q, acts)
    other = "thread" if run.layout == "warp" else "warp"
    ref = bk.make_bic_rollout(sim, other)(q, acts)
    torch.cuda.synchronize()
    check(all(same_bits(x, y) for x, y in zip(got, ref)),
          f"ball-in-a-cup branches: the {run.layout} layout's bits differ "
          f"from the {other} layout's")
    t0 = time.perf_counter()
    plain = bk.plain_bic_rollout(sim, q.cpu(), acts.cpu())
    plain_ms = 1e3 * (time.perf_counter() - t0)
    errs, _ = bic_errors(sim, tuple(x.cpu() for x in got), plain)
    successes = int(plain[2].sum())
    violated = int((plain[0][:, sim.layout.VIOLATED] != 0).sum())
    check(0 < successes and 0 < violated
          and successes + violated < BIC_BRANCH_N,
          f"ball-in-a-cup branch check: {successes} successes and "
          f"{violated} violated of {BIC_BRANCH_N}: a branch is not taken")
    return dict(layout=run.layout, errors=errs, successes=successes,
                violated=violated, bits_equal_other_layout=True,
                plain_cpu_ms=plain_ms)


def time_bic(dev):
    """Phase 40: both layouts of the ball-in-a-cup kernel through the
    wrapper in turns (thread, warp, warp, thread; CUDA events over
    BIC_TURN_LAUNCHES calls a reading after one) at the canonical
    search's shape (N=128, 250 + 1000 + 350 steps) and at the check's
    (N=1000, 10 + 20 + 10), and the bound: the f32 operations of the
    scalar program's N x steps lane steps over the f32 peak against the
    bytes it must move (the setpoints in, the final states and scores
    out) over the memory rate. ``kernel_ms`` is the routed layout's mean
    of its two turns at the canonical shape."""
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    out = {}
    for n, phases in ((BIC_N_TIME, None), (BIC_N_CHECK, BIC_PHASES)):
        sim = (BallInCupSim() if phases is None else BallInCupSim(
            stabilize_steps=phases[0], cooldown_steps=phases[2]))
        horizon = BIC_T if phases is None else phases[1]
        steps = sim.stabilize_steps + horizon + sim.cooldown_steps
        acts = bic_actions(n, horizon, 40, dev)
        q = torch.tensor(BIC_Q_START, device=dev)
        runs = {lay: bk.make_bic_rollout(sim, lay)
                for lay in ("thread", "warp")}
        turns = [[lay, cuda_ms(functools.partial(runs[lay], q, acts),
                               BIC_TURN_LAUNCHES[lay], warmup=1)]
                 for lay in ("thread", "warp", "warp", "thread")]
        key = f"N{n}_steps{steps}"
        out[f"turns_ms_{key}"] = turns
        for lay in runs:
            out[f"{lay}_ms_{key}"] = float(np.mean(
                [ms for name, ms in turns if name == lay]))
        if phases is None:
            routed = bk.route(sim)
            ops_step = bk.ops_per_lane_step(sim)
            nbytes = 4 * (4 + n * horizon * 4 + n * (sim.layout.size + 2))
            bound_ms, bound_by = least_time(ops_step * n * steps, nbytes)
            out.update(layout=routed, kernel_ms=out[f"{routed}_ms_{key}"],
                       ops_per_lane_step=ops_step, steps=steps,
                       bound_ms=bound_ms, bound_by=bound_by)
    return out


def search_layouts():
    """Phase 41's three iterations of the canonical search (MESH_SEARCH,
    unsharded) through each layout of the ball-in-a-cup kernel
    (``bic_kernel.route`` patched for the run): the final state, the trace
    and the generator's state bit-identical, three launches of that
    layout's kernel and none of the other's."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    from ppi_tpu_torch.parallel.mesh import _bits
    from ppi_tpu_torch.runners import run_policy_search as rps
    runs = {}
    route = bk.route
    try:
        for layout in ("thread", "warp"):
            bk.route = lambda sim, layout=layout: layout
            args = rps.build_parser().parse_args(MESH_SEARCH)
            args.mesh_devices = 0
            LAUNCHES.clear()
            t0 = time.perf_counter()
            policy, trace, gen = rps.search(args)[:3]
            torch.cuda.synchronize()
            runs[layout] = dict(
                state=run_state(policy),
                trace={k: v.cpu() for k, v in trace.items()},
                generator=gen.get_state(), wall_s=time.perf_counter() - t0,
                launches={lay: LAUNCHES[key]
                          for lay, key in bk.LAUNCH_KEYS.items()})
    finally:
        bk.route = route
    for layout, run in runs.items():
        want = {lay: 3 if lay == layout else 0 for lay in bk.LAUNCH_KEYS}
        check(run["launches"] == want,
              f"search through the {layout} layout: launches "
              f"{run['launches']}, expected {want}")
    a, b = runs["thread"], runs["warp"]
    check(torch.equal(a["generator"], b["generator"]),
          "search through each layout: the generator states differ")
    for part in ("trace", "state"):
        for k, v in a[part].items():
            check(torch.equal(_bits(b[part][k]), _bits(v)),
                  f"search through each layout: {part} {k} differs")
    res = {lay: dict(wall_s=r["wall_s"], launches=r["launches"])
           for lay, r in runs.items()}
    print(f"search through each layout (3 iterations of make "
          f"policy-search): final state, trace ({', '.join(sorted(a['trace']))}"
          f") and generator state bit-identical; {json.dumps(res)}",
          flush=True)
    return res


def decoded_frames(path):
    """How many frames ``path`` (a GIF or PNG by PIL, an AVI by the port's
    MJPEG reader) decodes to, and the first one's (H, W, 3)."""
    from PIL import Image, ImageSequence
    from ppi_tpu_torch.utils.video import read_avi_frames
    if Path(path).suffix == ".avi":
        frames = read_avi_frames(path)
    else:
        with Image.open(path) as im:
            frames = [np.asarray(f.convert("RGB"))
                      for f in ImageSequence.Iterator(im)]
    check(len(frames) > 0, f"{path}: no frame decoded")
    return len(frames), frames[0].shape


def traced_errors(sim, traced, kernel):
    """The traced trajectory's final state (``render.trace_bic_trajectory``
    on the host) against one launch of the kernel on the same setpoints:
    phase 39's measures (``bic_errors``' groups), unchecked."""
    st, pst = kernel[0].double(), torch.stack(
        sim.scalars(traced), -1)[None].double().to(kernel[0].device)
    L = sim.layout
    rel = (st - pst).abs() / (1.0 + pst.abs())
    fin = torch.isfinite(rel)
    rel = torch.where(fin, rel, 0.0)
    return {"state": float(rel[:, :L.FORCE].max()),
            "state_argmax": int(rel[:, :L.FORCE].argmax()),
            "stats": float(rel[:, L.MAX_POT:].max()),
            "reaction_abs": float((st - pst)[:, L.FORCE:L.MAX_POT]
                                  .abs().max()),
            "nonfinite_equal": bool(torch.equal(torch.isfinite(st),
                                                torch.isfinite(pst)))}


def policy_search_phase(tmp):
    """Phase 41: ``make policy-search`` through the port's runner on the
    card (every evaluation one launch of the ball-in-a-cup kernel), with
    ``--render --plot``: success rate 1.00 within its 40 iterations with
    exactly 40 launches, the curve at iterations 0, 10, 20, 30 and 39 and
    the wall time; the files of ``--render`` and ``--plot`` decoded; the
    traced mean trajectory's success (and its final state, reported)
    against one launch of the kernel on the same setpoints; then the Test
    env through the same runner, its final mean cost below 0.3 of its
    first, with no launch. The launches are counted by layout: the routed
    layout's kernel must take all 40, the other none."""
    from ppi_tpu_torch import render
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    from ppi_tpu_torch.runners import run_policy_search as rps
    i = POLICY_SEARCH.index("MonteCarlo")
    argv = POLICY_SEARCH[:i] + ["--render", "--plot", "--dir", str(tmp)] \
        + POLICY_SEARCH[i:]
    traced, spent = {}, {"trace_s": 0.0, "draw_s": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t
            return out
        return run

    trace_fn, draw_fn = render.trace_bic_trajectory, render.render_ball_in_a_cup
    render.trace_bic_trajectory = timed(trace_fn, "trace_s")
    render.render_ball_in_a_cup = timed(draw_fn, "draw_s")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        _, trace, rate = rps.main(
            rps.build_parser().parse_args(argv),
            on_trace=lambda path, acts, qh, ph, final: traced.update(
                path=path, actions=acts, qh=qh, final=final))
    finally:
        render.trace_bic_trajectory = trace_fn
        render.render_ball_in_a_cup = draw_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_layout = {lay: LAUNCHES[key] for lay, key in bk.LAUNCH_KEYS.items()}
    counted = [lay for lay, k in by_layout.items() if k]
    layout = counted[0] if len(counted) == 1 else None
    launches = by_layout[layout] if layout else sum(by_layout.values())
    curve = {i: {"success_rate": rate[i], "mean_cost": float(trace["mean"][i])}
             for i in (0, 10, 20, 30, 39)}
    first = rate.index(1.0) if 1.0 in rate else None
    search_wall = wall - spent["trace_s"] - spent["draw_s"]
    res = dict(launches=launches, layout=layout,
               launches_by_layout=by_layout, wall_s=search_wall,
               wall_with_render_s=wall, curve=curve,
               first_iteration_at_1=first, final_success_rate=rate[-1],
               success_rate=rate)
    print(f"make policy-search (Reps BallInACup RbfFeatures, epsilon 2.0, "
          f"40 iterations, N=128, seed 0): success rate 1.00 first at "
          f"iteration {first}; curve {json.dumps(curve)}; kernel launches "
          f"by layout {json.dumps(by_layout)}; wall {search_wall:.2f} s "
          f"without the render, {wall:.2f} s with it", flush=True)
    routed = bk.route(BallInCupSim())
    check(layout == routed and launches == 40,
          f"policy search: launches by layout {by_layout}, expected 40 of "
          f"the {routed} layout's kernel and none of the other's")
    check(first is not None, f"policy search: success rate never 1.00 "
          f"({rate})")
    # --render and --plot: the files, and the trace against the kernel
    run_dir = Path(traced["path"]).parent
    sim = BallInCupSim()
    steps = traced["qh"].shape[0]
    frames, shape = decoded_frames(traced["path"])
    check(steps == 1000 + sim.cooldown_steps and frames == -(-steps // 8)
          and shape == (500, 500, 3),
          f"ball_in_a_cup.gif: {frames} frames of {shape} for {steps} "
          "traced steps")
    for name in ("result.png", "policy_samples.png"):
        decoded_frames(run_dir / name)
    env = rps.make_env(rps.build_parser().parse_args(POLICY_SEARCH))
    kernel = env.rollout()(env.q_start.cuda(), traced["actions"][None])
    torch.cuda.synchronize()
    ok_trace = bool(sim.reward_and_success(traced["final"])[1])
    ok_kernel = bool(kernel[2][0])
    errs = traced_errors(sim, traced["final"], kernel)
    res["render"] = dict(trace_s=spent["trace_s"], draw_s=spent["draw_s"],
                         traced_steps=steps, gif_frames=frames,
                         traced_success=ok_trace,
                         kernel_success=ok_kernel,
                         traced_vs_kernel=errs)
    print(f"make policy-search --render --plot: the mean trajectory traced "
          f"({steps} steps on the host) in {spent['trace_s']:.2f} s, drawn "
          f"({frames} frames) in {spent['draw_s']:.2f} s; success traced "
          f"{ok_trace}, kernel {ok_kernel}; traced final state against the "
          f"kernel's {json.dumps(errs)} (phase 39's tolerances {BIC_TOL}, "
          f"{BIC_STATS_TOL}, {BIC_REACTION_ATOL} N); result.png and "
          "policy_samples.png decoded", flush=True)
    check(ok_trace == ok_kernel, f"the traced trajectory's success "
          f"{ok_trace}, the kernel's {ok_kernel}")
    # at phase 39's depth (10 + 20 + 10 steps of the same setpoints) the
    # trace is held to the kernel within phase 39's tolerances; over the
    # whole trajectory the last-ulp differences of the host's and the
    # card's sinf/cosf grow, so there the errors are reported
    n_stab, horizon, n_cool = BIC_PHASES
    short = BallInCupSim(stabilize_steps=n_stab, cooldown_steps=n_cool)
    acts = traced["actions"][:horizon]
    qs, qds = bk.joint_setpoints(acts[None])
    final = render.trace_bic_trajectory(short, env.q_start, qs[0],
                                        qds[0])[2]
    got = bk.make_bic_rollout(short)(env.q_start.cuda(), acts[None])
    torch.cuda.synchronize()
    short_errs = traced_errors(short, final, got)
    res["render"]["traced_vs_kernel_at_phase_39_depth"] = short_errs
    print(f"the trace at phase 39's depth ({BIC_PHASES} steps of the mean "
          f"trajectory's setpoints) against the kernel: "
          f"{json.dumps(short_errs)}", flush=True)
    check(short_errs["state"] <= BIC_TOL
          and short_errs["stats"] <= BIC_STATS_TOL
          and short_errs["reaction_abs"] <= BIC_REACTION_ATOL
          and short_errs["nonfinite_equal"],
          f"the trace at phase 39's depth against the kernel {short_errs}")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    _, trace, _ = rps.main(rps.build_parser().parse_args(TEST_SEARCH))
    torch.cuda.synchronize()
    first_cost, final_cost = float(trace["mean"][0]), float(trace["mean"][-1])
    res["test_env"] = dict(first=first_cost, final=final_cost,
                           wall_s=time.perf_counter() - t0)
    print(f"Test env (Reps, epsilon 2.0, N=64, 20 iterations): mean cost "
          f"{first_cost:.5g} -> {final_cost:.5g}; "
          f"{sum(LAUNCHES.values())} kernel launches", flush=True)
    check(final_cost < 0.3 * first_cost,
          f"Test env: final cost {final_cost} not below 0.3 x {first_cost}")
    check(sum(LAUNCHES.values()) == 0, "Test env: a kernel was launched")
    return res


def classic_phase():
    """Phase 42: the pendulum swing-up (tests/test_mpc.py's gate: the last
    five rewards average above -1.0 and above the first five by 5.0) and
    one cartpole episode (a finite return) through the port's run_mpc on
    the card; the eager objective plans them, so no kernel launches."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.runners import run_mpc
    res = {}
    for name, argv in (("pendulum", PENDULUM), ("cartpole", CARTPOLE)):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        ret, _, track = run_mpc.main(run_mpc.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        rewards = track["reward"].cpu().numpy()
        res[name] = dict(ret=ret, first5=float(rewards[:5].mean()),
                         last5=float(rewards[-5:].mean()),
                         wall_s=time.perf_counter() - t0,
                         launches=sum(LAUNCHES.values()))
        print(f"episode {name}: {json.dumps(res[name])}", flush=True)
        check(np.isfinite(ret), f"{name}: return {ret}")
        check(res[name]["launches"] == 0, f"{name}: a kernel was launched")
    p = res["pendulum"]
    check(p["last5"] > -1.0 and p["last5"] > p["first5"] + 5.0,
          f"pendulum: no swing-up (first five {p['first5']}, last five "
          f"{p['last5']})")
    return res


def sharded_phases(door, dev, ret4):
    """Phases 29-31: the unsharded references in this process (which built
    door-v0's body in phase 1, so no rank runs nvcc), then one spawned
    group of 4 ranks (gloo where they share the card) and one 1-rank nccl
    group running ``mesh_phases``. ``ret4`` is phase 4's return. Returns
    (the numbers for chip_smoke.json, the kernels line's entry)."""
    from ppi_tpu_torch.envs.base import risk_aggregate
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.parallel import launch, spawn
    rng = np.random.default_rng(29)
    acts = torch.from_numpy((0.4 * rng.standard_normal(
        (N_CHECK, H_CHECK, door.action_dim))).astype(np.float32)).to(dev)
    mask = (torch.arange(H_CHECK, device=dev) < H_CHECK - 5).float()
    s0 = door.reset(None, dev)
    c_full = rk.kernel_mpc_objective(door, s0, H_CHECK)(None, acts).cpu()
    c_mask = rk.kernel_mpc_objective(door, s0, H_CHECK, mask)(
        None, acts).cpu()
    c_plain = risk_aggregate(rk.env_plain_rollout(
        door, s0, *lanes(s0, N_CHECK), acts)[0]).cpu()
    # phase 29's warp-layout body: the unsharded launch on the parent,
    # whose phase 18 built it (no rank runs nvcc)
    from ppi_tpu_torch.runners.run_mpc import ENVS
    env_w = ENVS[MESH_WARP]()
    s_w = env_w.reset(torch.Generator(dev).manual_seed(0), dev)
    acts_w = s_w.physics.qpos[:env_w.action_dim] + torch.from_numpy(
        (0.3 * np.random.default_rng(30).standard_normal(
            (N_MESH_WARP, H_MESH_WARP, env_w.action_dim))).astype(
                np.float32)).to(dev)
    check(rk.kernel_layout(env_w) == "warp", f"{MESH_WARP}: not routed to "
          "the warp layout")
    c_warp = rk.kernel_mpc_objective(env_w, s_w, H_MESH_WARP)(
        None, acts_w).cpu()
    check(bool(torch.isfinite(c_warp).all()), f"{MESH_WARP}: unsharded "
          "costs not finite")
    ret20, _, _, got20 = run_episode(DOOR_ARGS + ["--timesteps", "20"], 64,
                                     key=rk.launch_key(door))
    check(got20 == 110, f"unsharded T=20 episode: {got20} launches")
    a = torch.from_numpy((0.4 * rng.standard_normal(
        (N_MESH, H_MESH, door.action_dim))).astype(np.float32)).to(dev)
    qn, qdn = lanes(s0, N_MESH)
    r = rk.env_rollout(door, s0, H_MESH)
    shard = N_MESH // MESH_RANKS
    mesh_t = {
        "unsharded_kernel_ms": cuda_ms(
            lambda: r(qn, qdn, a, dyn=s0.frame), 10),
        f"unsharded_kernel_ms_N{shard}": cuda_ms(
            lambda: r(qn[:shard], qdn[:shard], a[:shard], dyn=s0.frame), 10),
        "unsharded_ppi_iter_ms": time_ppi(
            door, s0, rk.kernel_mpc_objective(door, s0, H_MESH), N_MESH,
            H_MESH, MESH_ITERS)[0]}
    mesh_t["bound_ms_shard"], mesh_bound_by = rollout_bound(door, shard,
                                                            H_MESH)
    mesh_t["bound_ms_batch"] = rollout_bound(door, N_MESH, H_MESH)[0]
    # the unsharded references of the 4-rank group's run_opt,
    # run_policy_search and goal sweep (this process built both kernels in
    # phase 1 and pen-v0's body in phase 9)
    run_refs = unsharded_runs()
    goals_ref = goal_sweep(MESH_GOALS)
    cfg = dict(device="cuda", acts=acts.cpu().numpy(),
               mask=mask.cpu().numpy(), episode=door_args(250),
               short=door_args(20), episodes=True,
               warp_board=s_w.board.cpu().numpy(),
               warp_acts=acts_w.cpu().numpy(), opt=MESH_OPT,
               search=MESH_SEARCH, goals=MESH_GOALS)
    t0 = time.perf_counter()
    groups = {"4 ranks": spawn(mesh_phases, MESH_RANKS, cfg)}
    groups["1 rank"] = spawn(mesh_phases, 1, dict(cfg, episodes=False,
                                                  opt=None, goals=None))
    mesh_s = time.perf_counter() - t0
    check_sharded_runs(groups["4 ranks"], run_refs)
    goals_m = groups["4 ranks"]["goals"]
    per_episode = 50 + MESH_GOALS["timesteps"] * 3
    check(goals_m["episodes"] == goals_ref["episodes"],
          "sharded goal sweep: the episodes differ from the unsharded "
          f"sweep's: {goals_m['episodes']} against {goals_ref['episodes']}")
    check(goals_m["launches"] == [float(per_episode)] * MESH_RANKS
          and goals_ref["launches"] == per_episode * MESH_GOALS["resets"],
          f"sharded goal sweep: launches {goals_m['launches']} a rank, "
          f"{goals_ref['launches']} unsharded")
    print(f"check sharded goal sweep ({MESH_RANKS} ranks, gloo, one card): "
          f"goal_success {MESH_GOALS['env']} --resets "
          f"{MESH_GOALS['resets']} --timesteps {MESH_GOALS['timesteps']}: "
          "every episode's return, success and goal bit-identical to the "
          f"unsharded sweep's ({[e['return'] for e in goals_ref['episodes']]}"
          f", successes {[e['success'] for e in goals_ref['episodes']]}); "
          f"launches per rank {goals_m['launches']}; wall "
          f"{goals_m['wall_s']:.2f} s (unsharded {goals_ref['wall_s']:.2f} "
          "s)", flush=True)

    mesh_max_abs, warp_sharded = None, {}
    for label, res in groups.items():
        c, w = res["check"], res["ranks"]
        tag = f"{label}, {res['backend']}"
        check(res["backend"] == launch.backend_for("cuda", w),
              f"{tag}: backend")
        others = torch.arange(N_CHECK) != MESH_NAN_LANE
        errs = {"plain": rel_err(c["costs"], c_plain),
                "plain_sharded": rel_err(c["plain"], c_plain)}
        check(same_bits(c["costs"], c_full),
              f"{tag}: sharded costs differ from the unsharded launch")
        check(same_bits(c["masked"], c_mask), f"{tag}: masked costs")
        check(max(errs.values()) <= TOL, f"{tag}: vs plain {errs} > {TOL}")
        check(bool(torch.isnan(c["nan"][MESH_NAN_LANE]))
              and same_bits(c["nan"][others], c_full[others]),
              f"{tag}: a NaN lane must go NaN alone")
        # N_CHECK + 2 divides over 1 rank, not over 4
        check((c["divide"] is not None and "divide" in c["divide"])
              == (w == MESH_RANKS),
              f"{tag}: N={N_CHECK + 2} raised {c['divide']!r}")
        check(c["launches"] == [3.0] * w,
              f"{tag}: launches per rank {c['launches']}, expected 3 each")
        check(c["agree"], f"{tag}: ranks gathered different costs")
        if w == MESH_RANKS:
            mesh_max_abs = float((c["costs"] - c_full).abs().max())
        print(f"check sharded ({tag}): N={N_CHECK} H={H_CHECK}, "
              f"{N_CHECK // w} lanes a rank: costs and masked costs "
              f"bit-identical to the unsharded launch; vs plain "
              f"{json.dumps(errs)} (tol {TOL}); NaN lane {MESH_NAN_LANE} "
              f"alone; N={N_CHECK + 2}: {c['divide']!r}; launches per rank "
              f"{c['launches']}; every rank's costs identical", flush=True)
        cw = res["warp_check"]
        check(same_bits(cw["costs"], c_warp), f"{tag}: {MESH_WARP}'s sharded "
              "costs differ from the unsharded warp-layout launch")
        check(cw["launches"] == {"lane": [0.0] * w, "warp": [1.0] * w,
                                 "split": [0.0] * w},
              f"{tag}: {MESH_WARP}'s launches per rank {cw['launches']}, "
              "expected one of the warp layout each")
        check(cw["agree"], f"{tag}: ranks gathered different {MESH_WARP} "
              "costs")
        warp_sharded[label] = cw["launches"]
        print(f"check sharded ({tag}) {MESH_WARP}, warp layout: "
              f"N={N_MESH_WARP} H={H_MESH_WARP}, {N_MESH_WARP // w} lanes a "
              f"rank: costs bit-identical to the unsharded launch; launches "
              f"per rank {json.dumps(cw['launches'])}; every rank's costs "
              f"identical", flush=True)

    for label, res in groups.items():
        t = res["timings"]
        check(t["ppi_cost_finite"], f"{label}: PPI iteration cost not finite")
        mesh_t[f"{label}"] = t
    print(f"timings sharded (door-v0 N={N_MESH} H={H_MESH}, Lbps + SE 4dt): "
          f"{json.dumps(mesh_t)}; 4 processes time-slice one card (no MPS): "
          f"the 4-rank time measures overhead, not scale-out", flush=True)

    episodes_m = groups["4 ranks"]["episodes"]
    e = episodes_m["mesh"]
    check(f"{e['ret']:.2f}" == f"{ret4:.2f}",
          f"mesh episode return {e['ret']!r}, phase 4 {ret4!r}")
    check(e["success"], "mesh episode: door not open")
    check(e["launches"] == [800.0] * MESH_RANKS,
          f"mesh episode launches per rank {e['launches']}, expected 800")
    check(e["agree"], "mesh episode: the ranks' final policy states differ")
    for key in ("slices_samples", "samples"):
        m = episodes_m[key]
        check(f"{m['ret']:.2f}" == f"{ret20:.2f}",
              f"multislice {key}: return {m['ret']!r}, unsharded {ret20!r}")
        check(m["launches"] == [110.0] * MESH_RANKS,
              f"multislice {key}: launches per rank {m['launches']}")
        check(m["agree"], f"multislice {key}: the ranks' states differ")
    print(f"episodes sharded: {json.dumps(episodes_m)}; phase 4 return "
          f"{ret4!r} (exact: {e['ret'] == ret4}), unsharded T=20 "
          f"{ret20!r}; both spawned groups {mesh_s:.1f} s", flush=True)
    kernel = {
        "name": "door_sharded_rollout", "route": "cuda",
        "source": f"ppi_tpu_torch/csrc/{SOURCES[rk.kernel_layout(door)]}",
        "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:322",
        "launches": int(sum(e["launches"])), "max_abs_err": mesh_max_abs,
        "ms": float(np.mean(mesh_t["4 ranks"]["kernel_ms"])),
        "plain_ms": mesh_t["4 ranks"]["plain_ms"],
        "bound_ms": mesh_t["bound_ms_shard"], "bound_by": mesh_bound_by,
        "library_ms": None,
        # ms and bound_ms: one rank's shard; plain_ms: the batch on 4 ranks
        **shapes((N_MESH // MESH_RANKS, H_MESH), (N_MESH, H_MESH_PLAIN),
                 None)}
    sharded_runs_out = {
        key: {"launches": groups["4 ranks"][key]["launches"],
              "wall_s": groups["4 ranks"][key]["wall_s"],
              "unsharded_wall_s": run_refs[key]["wall_s"]}
        for key in ("opt", "search")}
    sharded_runs_out["goals"] = {
        "launches": goals_m["launches"], "wall_s": goals_m["wall_s"],
        "unsharded_wall_s": goals_ref["wall_s"]}
    return dict(mesh_timings=mesh_t, mesh_episodes=episodes_m,
                mesh_max_abs_err=mesh_max_abs, mesh_s=mesh_s,
                mesh_warp_check=warp_sharded,
                mesh_sharded_runs=sharded_runs_out), kernel


def shapes(shape, plain_shape, ms_at_plain_shape):
    """A kernels-line entry's shapes: (N, H) of its ``ms`` and
    ``bound_ms``, (N, H) of its ``plain_ms``, and the kernel's time at the
    plain rollout's shape where the two differ (null where not measured)."""
    return {"shape": list(shape), "plain_shape": list(plain_shape),
            "ms_at_plain_shape": ms_at_plain_shape}


def warp_header(env):
    """The warp layout's generated body for ``env``."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    return rk.generate_warp_header(*rk.body_args(env, state))


@contextlib.contextmanager
def layout_of(env_cls, layout):
    """``env_cls`` plans and steps through ``layout`` inside the block."""
    saved = env_cls.__dict__.get("scalar_kernel_layout")
    env_cls.scalar_kernel_layout = layout
    try:
        yield
    finally:
        if saved is None:
            del env_cls.scalar_kernel_layout
        else:
            env_cls.scalar_kernel_layout = saved


def padded_launch(run, q0, qd0, acts, consts, dyn, size):
    """One launch of ``run``'s kernel (``run.load()``) with ``size``
    threads (lane) or rollouts (warp) a block (None for the split layout,
    32 rollouts a block), into output buffers SENTINEL_PAD floats longer
    than the N rollouts fill, prefilled with SENTINEL: (rewards, qf, qdf,
    whether every pad kept its sentinel)."""
    fn = run.load()
    n, h = acts.shape[0], acts.shape[1]
    nq = q0.shape[1]
    dev = acts.device
    ins = [q0.t().contiguous(), qd0.t().contiguous(),
           acts.permute(1, 2, 0).contiguous()]
    outs = [torch.full((k * n + SENTINEL_PAD,), SENTINEL, device=dev)
            for k in (h, nq, nq)]
    ptr = lambda x: None if x is None else x.data_ptr()
    err = fn(*[x.data_ptr() for x in ins], ptr(dyn), ptr(consts),
             *[x.data_ptr() for x in outs], n, h,
             *(() if size is None else (size,)),
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"padded launch: CUDA error {err}")
    kept = all(bool((x[-SENTINEL_PAD:] == SENTINEL).all()) for x in outs)
    return (outs[0][:h * n].view(h, n).t(), outs[1][:nq * n].view(nq, n).t(),
            outs[2][:nq * n].view(nq, n).t(), kept)


def check_warp(name, env, dev):
    """Phase 33 for one env, on phase 14's or 26's lanes and plain results:
    the warp layout bit for bit the lane layout, and the plain version (the
    rewards within SCENE_TOL where they are not exact); a NaN lane, a
    second frame,
    board or goal that changes the rewards (and the mask on its costs), the
    sentinels past N, the real step. Returns (report, max abs error of the
    warp and of the lane layout against plain)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    c = CHECKED[name]
    exact = WARP[name]["exact_rewards"]
    s0, q0, qd0, acts = c["s0"], c["q0"], c["qd0"], c["acts"]
    h = acts.shape[1]
    consts, _, dyn = rk.kernel_operands(env, s0)
    lane_run = rk.env_rollout(env, s0, h, layout="lane")
    warp_run = rk.env_rollout(env, s0, h)
    check(warp_run.layout == "warp", f"{name}: routed to {warp_run.layout}")
    lane = lane_run(q0, qd0, acts, consts=consts, dyn=dyn)
    torch.cuda.synchronize()
    warp, plain = c["out"], c["plain"]
    rep = {"warp_equals_plain": all(same_bits(a, b)
                                    for a, b in zip(warp, plain)),
           "warp_matches_plain": (
               same_rewards(warp[0], plain[0], exact)
               and all(same_bits(a, b) for a, b in zip(warp[1:], plain[1:]))),
           "warp_equals_lane": all(same_bits(a, b)
                                   for a, b in zip(warp, lane)),
           "lane_equals_plain": all(same_bits(a, b)
                                    for a, b in zip(lane, plain))}
    err = {lay: max(float((a - b).abs().max()) for a, b in zip(out, plain))
           for lay, out in (("warp", warp), ("lane", lane))}
    check(rep["warp_equals_lane"], f"{name}: warp layout differs from the "
          "lane layout")
    check(rep["warp_matches_plain"], f"{name}: warp layout vs plain: the "
          f"state's bits, or the rewards {'bits' if exact else SCENE_TOL} "
          f"(max abs {err['warp']})")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    bad = [r(q0_bad, qd0, acts, consts=consts, dyn=dyn)[0]
           for r in (warp_run, lane_run)]
    keep = torch.arange(q0.shape[0], device=dev) != 3
    rep["nan_lane"] = (bool(torch.isnan(bad[0][3]).all())
                       and same_bits(bad[0][keep], warp[0][keep])
                       and same_bits(bad[0], bad[1]))
    check(rep["nan_lane"], f"{name}: a NaN lane must go NaN alone")

    # the second frame or board (dyn) or goal (consts) on its own lanes,
    # against the first's operands on the same lanes
    s1, hf = c["s1"], c["h_frame"]
    a = acts[:, :hf].contiguous()
    q1, qd1 = lanes(s1, q0.shape[0])
    c1, _, d1 = rk.kernel_operands(env, s1)
    r1 = [rk.env_rollout(env, s1, hf, layout=lay)(q1, qd1, a, consts=c1,
                                                  dyn=d1)[0]
          for lay in ("warp", "lane")]
    r0 = rk.env_rollout(env, s0, hf)(q1, qd1, a, consts=consts, dyn=dyn)[0]
    mask = (torch.arange(hf, device=dev) < max(hf - 2, 1)).float()
    costs = [rk.risk_aggregate(r, mask) for r in r1]
    rep["second_frame_and_mask"] = (
        same_bits(r1[0], r1[1]) and same_bits(costs[0], costs[1])
        and not bool(torch.equal(r1[0], r0))
        and not bool(torch.equal(costs[0], rk.risk_aggregate(r1[0]))))
    check(rep["second_frame_and_mask"], f"{name}: second frame, board or "
          "goal, or the mask")

    rew_s, qf_s, qdf_s, kept = padded_launch(warp_run, q0, qd0, acts,
                                             consts, dyn, SENTINEL_WARPS)
    rep["sentinels_kept"] = kept and all(
        same_bits(x, y) for x, y in zip((rew_s, qf_s, qdf_s), warp))
    check(rep["sentinels_kept"], f"{name}: {q0.shape[0]} rollouts in "
          f"blocks of {SENTINEL_WARPS}: a write past N, or other bits")

    action = acts[q0.shape[0] // 2, 0]
    s_k, r_k = env.step(s0, action)
    q_e, qd_e, r_e = rk.plain_step(env, s0, action)
    step_lane = rk.env_rollout(env, s0, 1, layout="lane")(
        s0.physics.qpos[None], s0.physics.qvel[None], action[None, None],
        consts=consts, dyn=dyn)
    rep["real_step"] = (same_bits(s_k.physics.qpos, q_e)
                        and same_bits(s_k.physics.qvel, qd_e)
                        and same_rewards(r_k, r_e, exact)
                        and same_bits(s_k.physics.qpos, step_lane[1][0])
                        and same_bits(r_k.reshape(1), step_lane[0][0]))
    check(rep["real_step"], f"{name}: warp real step vs plain_step or the "
          "lane layout")
    return rep, err


def warp_family(name):
    """(solver, prior, prior options) of ``name``'s canonical config."""
    for table in (ADROIT, SCENES, REST):
        if name in table:
            return table[name]["family"][:3]
    return HAND_FAMILY


def time_warp(name, env, dev):
    """Phase 34's timings for one env at the canonical shape (CUDA
    events): the lane layout at 128 threads a block, the warp layout as
    the env routes it, and both as the main path launches them in turns
    (lane, warp, warp, lane); the real step in both layouts; a synced PPI
    iteration (the canonical solver and prior) in both layouts."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    from ppi_tpu_torch.studies.warp_layout import lanes as study_lanes
    from ppi_tpu_torch.studies.warp_layout import rollout as study_rollout
    n, h = WARP[name]["shape"]
    s0 = env.reset(torch.Generator(dev).manual_seed(0), dev)
    consts, _, dyn = rk.kernel_operands(env, s0)
    out = {"ops_per_lane_step": rk.ops_per_lane_step(*rk.body_args(
        env, env.reset(torch.Generator().manual_seed(0), "cpu")))}
    out[f"bound_ms_N{n}_H{h}"], out["bound_by"] = rollout_bound(env, n, h)
    q0, qd0, acts = study_lanes(env, s0, n, h, 0.3)
    lane = study_rollout(env, s0, h, "lane", 128)
    out[f"lane_128_ms_N{n}_H{h}"] = cuda_ms(
        lambda: lane(q0, qd0, acts, consts=consts, dyn=dyn), 10, 1)
    r = rk.env_rollout(env, s0, h)
    out[f"warp_ms_N{n}_H{h}"] = cuda_ms(
        lambda: r(q0, qd0, acts, consts=consts, dyn=dyn), 10, 1)
    # the two layouts as the main path launches them, in turns: lane, warp,
    # warp, lane at the canonical shape (the layout each env keeps)
    runs = {"lane": lane,
            "warp": study_rollout(env, s0, h, "warp", rk.WARPS_PER_BLOCK)}
    out[f"abba_ms_N{n}_H{h}"] = [
        [lay, cuda_ms(lambda: runs[lay](q0, qd0, acts, consts=consts,
                                        dyn=dyn), 10, 1)]
        for lay in ("lane", "warp", "warp", "lane")]

    alg, policy, kwargs = warp_family(name)
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        policy, env.dt * torch.arange(h), env.action_dim, mean, cov_in,
        cov_out, lower=env.action_low, upper=env.action_high, device=dev,
        **kwargs)
    for layout in ("warp", "lane"):
        with layout_of(type(env), layout):
            step = _one_iteration(
                make_solver(alg, delta=0.9, alpha=10.0, n_elites=10,
                            dimension=family.dim_features), family,
                rk.kernel_mpc_objective(env, s0, h), n)
            gen = torch.Generator(dev).manual_seed(0)
            st = state
            for _ in range(2):
                st, (stats, _, _) = step(st, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                st, (stats, _, _) = step(st, gen)
                torch.cuda.synchronize()
            out[f"{layout}_ppi_iter_ms_N{n}_H{h}"] = \
                1e3 * (time.perf_counter() - t0) / 5
            check(bool(torch.isfinite(stats["mean"])),
                  f"{name}: PPI iteration cost not finite ({layout})")
            action = family.predict_mean(st)[0]
            env.step(s0, action)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                s1, _ = env.step(s0, action)
            torch.cuda.synchronize()
            out[f"{layout}_step_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    return out


def turns_mean(times, shape, layout, turns="turns_ms"):
    """The mean of ``layout``'s two times in phase 37's ``turns`` (the
    whole calls, or the kernels alone: "kernel_turns_ms") at ``shape``."""
    n, h = shape
    return float(np.mean([ms for lay, ms in times[f"{turns}_N{n}_H{h}"]
                          if lay == layout]))


def regs_spills(ptxas):
    """{registers, spill_stores_bytes, spill_loads_bytes} of a kernel from
    its ``-Xptxas -v`` lines."""
    text = " ".join(ptxas)
    regs = re.search(r"Used (\d+) registers", text)
    stores = re.search(r"(\d+) bytes spill stores", text)
    loads = re.search(r"(\d+) bytes spill loads", text)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores_bytes": int(stores.group(1)) if stores else None,
            "spill_loads_bytes": int(loads.group(1)) if loads else None}


def ptxas_by_kernel(lib):
    """{entry function: {registers, spill_stores_bytes, spill_loads_bytes}}
    from a build's ``-Xptxas -v`` log."""
    lines, name = {}, None
    for ln in (lib.parent / "build.log").read_text().splitlines():
        entry = re.search(r"entry function '(\w+)'", ln)
        if entry:
            name = entry.group(1)
            lines[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            lines[name].append(ln.strip())
    return {name: regs_spills(v) for name, v in lines.items()}


def split_build(env):
    """(library, nvcc seconds, header) of ``env``'s split-layout body,
    through the wrapper's own caches (so the main path reuses the build)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    header = rk._split_header(*rk.body_args(env, state),
                              rk.split_partition(env))
    t0 = time.perf_counter()
    lib = rk._split_library(header)
    return lib, time.perf_counter() - t0, header


def split_occupancy(lib):
    """Blocks of the split kernel an SM holds at once."""
    from ppi_tpu_torch.build import load_function
    fn = load_function(lib, "ppi_rollout_split_occupancy", 1, 0,
                       stream=False)
    # the launch raises the kernel's shared-memory limit first
    blocks = np.zeros(1, np.int32)
    check(fn(blocks.ctypes.data) == 0, "occupancy query failed")
    return int(blocks[0])


def check_split(name, env, dev, c):
    """Phase 36 for one env on a phase's lanes and plain results ``c``
    (door-v0: phase 2's, N=1000, H=20, the nominal frame; hammer-v0 and
    pen-v0-hand: phase 18's; relocate-v0, cheetah and pen-v0: phase 10's;
    walker2d, walker~walk, humanoid-standup, fetch-push, hopper, reacher
    and finger~spin: phase 22's): the split layout bit for bit the lane
    kernel (rewards, qf, qdf) and the plain version within
    SPLIT's tolerance (bit identity reported); a NaN lane (NaN alone, both
    layouts' bits equal); the second frame, board, goal or start with the
    mask on its costs, both layouts' bits equal and the costs moved (by
    the frame, board or goal alone where the env has one); N=1000 (31
    groups of 32 and 8 more) into outputs
    padded past N with a sentinel that must stay; the real step (N=1, H=1)
    bit for bit both layouts and within the tolerance of ``plain_step``.
    Returns (report, max abs error of the split and the lane layout
    against plain)."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    s0, q0, qd0, acts = c["s0"], c["q0"], c["qd0"], c["acts"]
    h = acts.shape[1]
    consts, _, dyn = rk.kernel_operands(env, s0)
    runs = {lay: rk.env_rollout(env, s0, h, layout=lay)
            for lay in ("lane", "split")}
    out = {lay: r(q0, qd0, acts, consts=consts, dyn=dyn)
           for lay, r in runs.items()}
    torch.cuda.synchronize()
    plain = c["plain"]
    rep = {"split_equals_lane": all(same_bits(a, b) for a, b in
                                    zip(out["split"], out["lane"])),
           "split_equals_plain": all(same_bits(a, b) for a, b in
                                     zip(out["split"], plain)),
           "split_vs_plain": max(rel_err(a, b) for a, b in
                                 zip(out["split"], plain))}
    err = {lay: max(float((a - b).abs().max()) for a, b in zip(o, plain))
           for lay, o in out.items()}
    check(rep["split_equals_lane"], f"{name}: split layout differs from "
          "the lane layout")
    check(rep["split_vs_plain"] <= SPLIT[name]["tol"], f"{name}: split "
          f"layout vs plain {rep['split_vs_plain']}")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    bad = {lay: r(q0_bad, qd0, acts, consts=consts, dyn=dyn)
           for lay, r in runs.items()}
    keep = torch.arange(q0.shape[0], device=dev) != 3
    rep["nan_lane"] = (bool(torch.isnan(bad["split"][0][3]).all())
                       and same_bits(bad["split"][0][keep],
                                     out["split"][0][keep])
                       and all(same_bits(a, b) for a, b in
                               zip(bad["split"], bad["lane"])))
    check(rep["nan_lane"], f"{name}: a NaN lane must go NaN alone")

    s1, hf = c["s1"], c["h_frame"]
    a = acts[:, :hf].contiguous()
    q1, qd1 = lanes(s1, q0.shape[0])
    c1, _, d1 = rk.kernel_operands(env, s1)
    r1 = [rk.env_rollout(env, s1, hf, layout=lay)(q1, qd1, a, consts=c1,
                                                  dyn=d1)[0]
          for lay in ("split", "lane")]
    operands = consts is not None or dyn is not None
    r0 = (runs["split"](q1, qd1, acts, consts=consts, dyn=dyn) if operands
          else out["split"])[0][:, :hf]
    mask = (torch.arange(hf, device=dev) < max(hf - 2, 1)).float()
    costs = [rk.risk_aggregate(r, mask) for r in r1]
    rep["second_frame_and_mask"] = (
        same_bits(r1[0], r1[1]) and same_bits(costs[0], costs[1])
        and not bool(torch.equal(r1[0], r0))
        and not bool(torch.equal(costs[0], rk.risk_aggregate(r1[0]))))
    check(rep["second_frame_and_mask"], f"{name}: second frame or board, "
          "or the mask")

    rew_s, qf_s, qdf_s, kept = padded_launch(runs["split"], q0, qd0, acts,
                                             consts, dyn, None)
    rep["sentinels_kept"] = kept and all(
        same_bits(x, y) for x, y in zip((rew_s, qf_s, qdf_s), out["split"]))
    check(rep["sentinels_kept"], f"{name}: {q0.shape[0]} rollouts in groups "
          "of 32: a write past N, or other bits")

    action = acts[q0.shape[0] // 2, 0]
    s_k, r_k = env.step(s0, action)
    q_e, qd_e, r_e = rk.plain_step(env, s0, action)
    step = {lay: rk.env_rollout(env, s0, 1, layout=lay)(
        s0.physics.qpos[None], s0.physics.qvel[None], action[None, None],
        consts=consts, dyn=dyn) for lay in ("lane", "split")}
    rep["real_step_vs_plain"] = max(
        rel_err(s_k.physics.qpos, q_e), rel_err(s_k.physics.qvel, qd_e),
        rel_err(r_k, r_e))
    rep["real_step"] = (
        rep["real_step_vs_plain"] <= SPLIT[name]["tol"]
        and all(same_bits(s_k.physics.qpos, o[1][0])
                and same_bits(s_k.physics.qvel, o[2][0])
                and same_bits(r_k.reshape(1), o[0][0])
                for o in step.values()))
    check(rep["real_step"], f"{name}: real step vs plain_step or either "
          "layout")
    return rep, err


def time_split(name, env, dev):
    """Phase 37's timings for one env: the kernels alone (the wrapper's
    ``run.launch`` on what its ``run.stage`` laid out once) in turns
    (lane, split, split, lane) at the canonical shape after 0.5 s of the
    lane kernel's launches, 200 launches a reading; CUDA events of the
    main path's whole call in turns (lane, split, split, lane; lane, warp,
    split, split, warp, lane for an env whose SPLIT entry names the warp
    layout too) at the canonical shape and lane, split, split, lane at
    SPLIT's larger shapes; the real step (host clock) and a synced PPI
    iteration (the canonical solver and prior) in the lane and split
    layouts; the bound at each shape."""
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    from ppi_tpu_torch.studies.split_layout import READING, warm
    from ppi_tpu_torch.studies.warp_layout import lanes as study_lanes
    cfg = SPLIT[name]
    n, h = cfg["shape"]
    s0 = env.reset(torch.Generator(dev).manual_seed(0), dev)
    consts, _, dyn = rk.kernel_operands(env, s0)
    out = {"ops_per_lane_step": rk.ops_per_lane_step(*rk.body_args(
        env, env.reset(torch.Generator().manual_seed(0), "cpu")))}
    q0, qd0, acts = study_lanes(env, s0, n, h, 0.3)
    alone = {}
    for lay in ("lane", "split"):
        r = rk.env_rollout(env, s0, h, layout=lay)
        alone[lay] = functools.partial(r.launch, r.stage(
            q0, qd0, acts, consts=consts, dyn=dyn))
        alone[lay]()   # loads the build: no reading times the load
    warm(alone["lane"])
    out[f"kernel_turns_ms_N{n}_H{h}"] = [
        [lay, cuda_ms(alone[lay], READING, 0)]
        for lay in ("lane", "split", "split", "lane")]
    for nn, hh in ((n, h), *cfg["big"]):
        q0, qd0, acts = study_lanes(env, s0, nn, hh, 0.3)
        turns = (("lane", "warp", "split") if cfg.get("warp") and nn == n
                 else ("lane", "split"))
        runs = {lay: rk.env_rollout(env, s0, hh, layout=lay)
                for lay in turns}
        iters = 20 if nn == n else 3
        out[f"turns_ms_N{nn}_H{hh}"] = [
            [lay, cuda_ms(lambda: runs[lay](q0, qd0, acts, consts=consts,
                                            dyn=dyn), iters, 1)]
            for lay in turns + turns[::-1]]
        out[f"bound_ms_N{nn}_H{hh}"], out["bound_by"] = rollout_bound(
            env, nn, hh)

    # the solver and prior of phase 3's, 11's, 19's or 23's iteration, and
    # the Mppi temperature of phase 11's (10) or 23's (REST's fourth field)
    if name == "door-v0":
        alg, policy, kwargs = ("Lbps", "SquaredExponentialKernel",
                               {"lengthscale": 0.08})
        alpha = {}
    elif name in REST:
        alg, policy, kwargs, temperature = REST[name]["family"]
        alpha = {"alpha": temperature}
    elif name in VARIANT_B:
        (alg, policy, kwargs), alpha = VARIANT_B[name]["family"], {
            "alpha": 10.0}
    else:
        (alg, policy, kwargs), alpha = SCENES[name]["family"], {}
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, state = make_policy(
        policy, env.dt * torch.arange(h), env.action_dim, mean, cov_in,
        cov_out, lower=env.action_low, upper=env.action_high, device=dev,
        **kwargs)
    for layout in ("split", "lane"):
        with layout_of(type(env), layout):
            step = _one_iteration(
                make_solver(alg, delta=0.9, n_elites=10,
                            dimension=family.dim_features, **alpha), family,
                rk.kernel_mpc_objective(env, s0, h), n)
            gen = torch.Generator(dev).manual_seed(0)
            st = state
            for _ in range(2):
                st, (stats, _, _) = step(st, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                st, (stats, _, _) = step(st, gen)
                torch.cuda.synchronize()
            out[f"{layout}_ppi_iter_ms_N{n}_H{h}"] = \
                1e3 * (time.perf_counter() - t0) / 5
            check(bool(torch.isfinite(stats["mean"])),
                  f"{name}: PPI iteration cost not finite ({layout})")
            action = family.predict_mean(st)[0]
            env.step(s0, action)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                env.step(s0, action)
            torch.cuda.synchronize()
            out[f"{layout}_step_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    return out


# phases 43-45: resume, prior fitting and the evaluation runners. Phase
# 43 stops phase 4's episode after the checkpoint at RESUME_STOP (of one
# every RESUME_EVERY steps) and resumes it; its crash-window case resumes
# from the checkpoint at RESUME_TRIM with the track of the whole episode.
RESUME_EVERY, RESUME_STOP, RESUME_TRIM = 50, 100, 200
# phase 45: goal_success's pen-v0 sweep, multi_start's door-v0 restarts,
# one profile_mpc triple, corl_curves' smoke grid
GOAL_ENV, GOAL_RESETS = "pen-v0", 3
RESTART_ENV, RESTARTS = "door-v0", 2
PROFILE_RUNS = 20
PROFILE = ["--env", "door-v0", "--combos", "Lbps/SquaredExponentialKernel",
           "--n-samples", "64", "--runs", str(PROFILE_RUNS)]
CORL_T = 60
# phase 44's model selection fits the family run_mpc then plans with (each
# family is 1,500 Adam steps of a few hundred small launches: 45 s for all
# four on a slow host)
MS_KERNELS = ["SquaredExponentialKernel"]
# phase 31's sharded goal sweep: pen-v0, one reset a rank, T=10
MESH_GOALS = dict(env="pen-v0", resets=4, timesteps=10)

# phase 46: the palm-IK kernel's five bodies. Per body: the IK variables,
# the level penalty's weight (None: none) and lr of its expert's calls,
# and their iteration counts (door: the pre-press 1,500, each sweep 800).
# The check runs IK_CHECK_ITERS iterations against the plain version on
# the card (autograd through the sites: 2.5k-8.7k eager launches an
# iteration), the plain version is timed at IK_PLAIN_ITERS; the kernel's
# x to IK_TOL (the gradient by the geometric Jacobian against autograd's
# chain rule: 0 to 5e-7 apart after 50 iterations on the CPU)
IK_BODIES = {
    "door-v0-hand": dict(n_var=10, level=None, lr=0.03, iters=(1500, 800)),
    "door-v0-adroit": dict(n_var=21, level=None, lr=0.03,
                           iters=(1500, 800)),
    "hammer-v0-hand": dict(n_var=4, level=0.05, lr=0.02, iters=(500,)),
    "hammer-v0-adroit": dict(n_var=4, level=0.005, lr=0.02, iters=(500,)),
    "relocate-v0-adroit": dict(n_var=4, level=0.05, lr=0.05, iters=(1000,)),
}
IK_CHECK_ITERS, IK_PLAIN_ITERS, IK_TOL = 20, 2, 1e-5
# one thread's dependent chain: cycles an f32 operation waits for its
# operand (a math call counted as one operation), at the H100 SXM's
# 1,980 MHz boost clock
CHAIN_CYCLES, SM_HZ = 4, 1.98e9
# phase 47: collect_expert at the canonical door-v0 config, one episode
COLLECT = ["--env", "door-v0", "--algorithm", "Lbps", "--policy",
           "SquaredExponentialKernel", "--lengthscale", "0.08", "--episodes",
           "1", "--timesteps", "250", "--horizon", "30", "--n-samples", "64",
           "--n-iters", "2", "--anneal", "0.5", "--warmstart", "50",
           "--seed", "0", "--device", "cuda"]
# phase 48: SAC on humanoid-standup, 5 chunks at the default sizes (64 env
# steps and 64 updates of 256 a chunk), then 200 steps of the trained mean
SAC_CHUNKS, SAC_COLLECT = 5, 200


class Crash(Exception):
    """The stop of phase 43's first run, after a checkpoint."""


def state_tensors(state, prefix=""):
    """An env state's tensors by dotted field name (nested dataclasses)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(state_tensors(v, f"{prefix}{f.name}."))
    return out


def same_run(track, state, ref_track, ref_state, tag):
    """Check a run's track (every key of the reference's) and final env
    state bit for bit against the reference's."""
    check(sorted(track) == sorted(ref_track), f"{tag}: track keys "
          f"{sorted(track)}")
    for k, v in ref_track.items():
        check(same_bits(track[k], v), f"{tag}: track {k} differs")
    ref = state_tensors(ref_state)
    got = state_tensors(state)
    check(sorted(got) == sorted(ref), f"{tag}: state fields")
    for k, v in ref.items():
        check(torch.equal(v, got[k]) if not v.is_floating_point()
              else same_bits(got[k], v), f"{tag}: final state {k} differs")


def door_run_argv(tmp, *extra, timesteps=250):
    """door_args(timesteps) with a result directory and ``extra`` before
    the sampler."""
    argv = door_args(timesteps)
    i = argv.index("MonteCarlo")
    return argv[:i] + ["--dir", str(tmp), *extra] + argv[i:]


def resume_phase(ref_track, ref_state, tmp):
    """Phase 43: phase 4's episode with a checkpoint every RESUME_EVERY
    steps, stopped after the one at RESUME_STOP and resumed, and the
    crash window (the whole track beside the checkpoint at RESUME_TRIM)
    resumed: both bit for bit phase 4's track and final state, with their
    launches."""
    import shutil
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.runners import run_mpc
    key = rk.launch_key(Door())
    ckpt = ["--checkpoint-every", str(RESUME_EVERY)]
    parse = lambda *extra: run_mpc.build_parser().parse_args(
        door_run_argv(tmp, *ckpt, *extra))
    out = {}

    def stop(t, carry, state):
        if t == RESUME_STOP:
            raise Crash

    LAUNCHES.clear()
    t0 = time.perf_counter()
    stopped = False
    try:
        run_mpc.main(parse(), on_checkpoint=stop)
    except Crash:
        stopped = True
    torch.cuda.synchronize()
    out["stopped_wall_s"] = time.perf_counter() - t0
    check(stopped, "phase 43: the first run did not stop at its checkpoint")
    out["launches_before"] = LAUNCHES[key]
    (run_dir,) = [d for d in Path(tmp).iterdir() if d.is_dir()]
    snap = Path(tmp) / "at_trim"
    final = {}

    def keep(t, carry, state):
        if t == RESUME_TRIM:
            snap.mkdir()
            shutil.copy(run_dir / "episode_checkpoint.npz", snap)
        final.update(t=t, state=state)

    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(parse("--resume"), on_checkpoint=keep)
    torch.cuda.synchronize()
    out.update(resumed_wall_s=time.perf_counter() - t0,
               launches_after=LAUNCHES[key], ret=ret, success=success)
    same_run(track, final["state"], ref_track, ref_state, "phase 43 resume")
    check(final["t"] == 250, f"phase 43: last checkpoint at {final['t']}")
    check(out["launches_before"] == 50 + RESUME_STOP * 3
          and out["launches_after"] == (250 - RESUME_STOP) * 3,
          f"phase 43: launches {out['launches_before']} + "
          f"{out['launches_after']}, expected 350 + 450")
    # the crash window: the track written at step 250, the checkpoint of
    # step RESUME_TRIM (a crash between the last two writes)
    shutil.copy(snap / "episode_checkpoint.npz", run_dir)
    rows = np.load(run_dir / "episode_track.npz")
    check(len(rows["reward"]) == 250, "phase 43: the whole track not kept")
    LAUNCHES.clear()
    ret_t, _, track_t = run_mpc.main(parse("--resume"),
                                     on_checkpoint=keep)
    same_run(track_t, final["state"], ref_track, ref_state,
             "phase 43 crash window")
    out["trim_launches"] = LAUNCHES[key]
    check(out["trim_launches"] == (250 - RESUME_TRIM) * 3,
          f"phase 43: crash-window resume {out['trim_launches']} launches")
    out["data_npz"] = str(run_dir / "data.npz")
    print(f"resume (phase 43): door-v0 checkpointed every {RESUME_EVERY} "
          f"steps, stopped after step {RESUME_STOP} "
          f"({out['launches_before']} launches, {out['stopped_wall_s']:.1f} "
          f"s), resumed to 250 ({out['launches_after']} launches, "
          f"{out['resumed_wall_s']:.1f} s): track and final state bit for "
          f"bit phase 4's, return {ret!r}, success {success}; the track of "
          f"250 rows beside the checkpoint of step {RESUME_TRIM} trimmed and "
          f"resumed ({out['trim_launches']} launches) to the same bits",
          flush=True)
    return out


def log_line(run_dir, pattern):
    """The groups of the first line of a run's ``log`` matching
    ``pattern``."""
    m = re.search(pattern, (Path(run_dir) / "log").read_text())
    check(m is not None, f"no {pattern!r} in {run_dir}/log")
    return m.groups()


def prior_phase(expert_npz, tmp):
    """Phase 44: ``run_mpc --optimize-prior`` at the canonical door-v0
    config, then ``model_selection --expert`` on ``expert_npz`` (phase
    47's collect_expert episode) and ``run_mpc --model-selection`` with its
    artifact."""
    from ppi_tpu_torch import model_selection
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies.kernels import BaseKernel
    from ppi_tpu_torch.runners import run_mpc
    key = rk.launch_key(Door())
    out = {}
    at_first = []
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(
        run_mpc.build_parser().parse_args(door_run_argv(
            Path(tmp) / "opt", "--optimize-prior")),
        lambda t, state, row: t == 0 and at_first.append(LAUNCHES[key]))
    torch.cuda.synchronize()
    (run_dir,) = (Path(tmp) / "opt").iterdir()
    old, new, fit_s = log_line(
        run_dir, r"optimize-prior: hyper (\[[^\]]*\]) -> (\[[^\]]*\]), "
        r"fit ([0-9.]+) s")
    old, new = json.loads(old), json.loads(new)
    bounds = BaseKernel(horizon=30, action_dim=4).param_bounds
    out["optimize_prior"] = dict(
        ret=ret, success=success, launches=LAUNCHES[key], hyper_old=old,
        hyper_new=new, fit_s=float(fit_s), first_step_launches=at_first[0],
        wall_s=time.perf_counter() - t0)
    check(np.isfinite(ret) and bool(torch.isfinite(track["action"]).all()),
          f"phase 44: --optimize-prior return {ret}")
    check(new != old, f"phase 44: hyperparameters unchanged {old}")
    check(all(lo <= v <= hi for v, (lo, hi) in zip(new, bounds)),
          f"phase 44: hyperparameters {new} outside {bounds}")
    check(out["optimize_prior"]["launches"] == 800,
          f"phase 44: {out['optimize_prior']['launches']} launches")
    # the warm start's 50, then step 0's two iterations and real step: the
    # fit between them launches nothing
    check(at_first[0] == 50 + 3, f"phase 44: {at_first[0]} launches by step "
          "0: the fit launched a kernel")
    check(success, f"phase 44: --optimize-prior did not open the door "
          f"(return {ret:.2f})")
    print(f"prior fit (phase 44): run_mpc --optimize-prior, hyper {old} -> "
          f"{new} (fit {float(fit_s):.3f} s, no launch), return {ret:.2f}, "
          f"success {success}, {out['optimize_prior']['launches']} launches",
          flush=True)

    artifact = Path(tmp) / "model_selection.npz"
    t0 = time.perf_counter()
    payload = model_selection.main(model_selection.build_parser().parse_args(
        ["--expert", str(expert_npz), "--horizon", "30", "--dt",
         str(Door().dt), "--out", str(artifact), "--kernels",
         *MS_KERNELS]))
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    se = payload["SquaredExponentialKernel"]
    check(all(np.all(np.isfinite(e["param"])) and np.isfinite(e["kl"])
              for e in payload.values()), "phase 44: model selection not "
          "finite")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret_ms, success_ms, track_ms = run_mpc.main(
        run_mpc.build_parser().parse_args(door_run_argv(
            Path(tmp) / "ms", "--model-selection", str(artifact))))
    torch.cuda.synchronize()
    out["model_selection"] = dict(
        fit_wall_s=fit_wall, param=se["param"].tolist(), kl=se["kl"],
        params={k: e["param"].tolist() for k, e in payload.items()},
        kls={k: e["kl"] for k, e in payload.items()}, ret=ret_ms,
        success=success_ms, launches=LAUNCHES[key],
        wall_s=time.perf_counter() - t0)
    check(np.isfinite(ret_ms)
          and bool(torch.isfinite(track_ms["action"]).all()),
          f"phase 44: --model-selection return {ret_ms}")
    check(out["model_selection"]["launches"] == 800,
          f"phase 44: --model-selection {LAUNCHES[key]} launches")
    print(f"prior fit (phase 44): model_selection on phase 47's expert "
          f"({fit_wall:.2f} s, {len(payload)} kernel(s) x 1,500 Adam steps): "
          f"SE param "
          f"{se['param'].tolist()} kl {se['kl']:.4f}; run_mpc "
          f"--model-selection return {ret_ms:.2f}, success {success_ms} "
          f"(reported, not gated), {LAUNCHES[key]} launches", flush=True)
    return out


def runner_phase(tmp):
    """Phase 45: goal_success, multi_start, profile_mpc and corl_curves
    through their CLIs on the card."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.runners import (
        corl_curves, goal_success, multi_start, profile_mpc)
    from ppi_tpu_torch.runners.run_mpc import ENVS
    out = {}
    pen_key = rk.launch_key(ENVS[GOAL_ENV]())
    door_key = rk.launch_key(ENVS[RESTART_ENV]())
    LAUNCHES.clear()
    t0 = time.perf_counter()
    goals = goal_success.main(["--env", GOAL_ENV, "--resets",
                               str(GOAL_RESETS)])
    torch.cuda.synchronize()
    out["goal_success"] = dict(
        success_rate=goals["success_rate"], goal_spread=goals["goal_spread"],
        returns=[e["return"] for e in goals["episodes"]],
        launches=LAUNCHES[pen_key], wall_s=time.perf_counter() - t0)
    check(goals["success_rate"] >= 2 / 3, f"phase 45: {GOAL_ENV} success "
          f"rate {goals['success_rate']}")
    check(goals["goal_spread"] > 0.0, "phase 45: the goals did not differ")
    check(LAUNCHES[pen_key] == GOAL_RESETS * 350,
          f"phase 45: goal sweep {LAUNCHES[pen_key]} launches, expected "
          f"{GOAL_RESETS} x 350")

    LAUNCHES.clear()
    t0 = time.perf_counter()
    restarts = multi_start.main(["--env", RESTART_ENV, "--restarts",
                                 str(RESTARTS)])
    torch.cuda.synchronize()
    frame = ENVS[RESTART_ENV]().reset(
        torch.Generator("cuda").manual_seed(0), "cuda").frame
    out["multi_start"] = dict(
        returns=restarts["returns"], success_any=restarts["success_any"],
        n_success=restarts["n_success"], goal=restarts["goal"],
        launches=LAUNCHES[door_key], wall_s=time.perf_counter() - t0)
    check(np.allclose(restarts["goal"], frame.cpu().numpy(), atol=1e-4),
          f"phase 45: restarts faced {restarts['goal']}, not the task's "
          "frame")
    check(LAUNCHES[door_key] == RESTARTS * 800,
          f"phase 45: restarts {LAUNCHES[door_key]} launches")

    LAUNCHES.clear()
    prof = profile_mpc.main(profile_mpc.build_parser().parse_args(PROFILE))
    (ms_step,) = [1e3 * v for v in prof["timings_s"].values()]
    out["profile_mpc"] = dict(ms_per_control_step=ms_step,
                              launches=LAUNCHES[door_key])
    check(np.isfinite(ms_step) and ms_step > 0.0
          and LAUNCHES[door_key] == 1 + PROFILE_RUNS,
          f"phase 45: profile_mpc {ms_step} ms, {LAUNCHES[door_key]} "
          "launches")

    LAUNCHES.clear()
    t0 = time.perf_counter()
    rows = corl_curves.main(corl_curves.build_parser().parse_args(
        ["--seeds", "1", "--timesteps", str(CORL_T), "--dir",
         str(Path(tmp) / "corl")]))
    torch.cuda.synchronize()
    out["corl_curves"] = dict(
        returns={k: r["return_mean"] for k, r in rows.items()},
        success={k: r["success_rate"] for k, r in rows.items()},
        launches=LAUNCHES[door_key], wall_s=time.perf_counter() - t0)
    # Cem and Essps one iteration a step, Lbps two; a warm start of 50
    want = 3 * (50 + CORL_T) + CORL_T * (1 + 2 + 1)
    check(len(rows) == 3 and all(np.isfinite(r["return_mean"])
                                 for r in rows.values()),
          f"phase 45: corl_curves returns {out['corl_curves']['returns']}")
    check((Path(tmp) / "corl" / "overlay.png").stat().st_size > 0,
          "phase 45: no overlay.png")
    check(LAUNCHES[door_key] == want, f"phase 45: corl_curves "
          f"{LAUNCHES[door_key]} launches, expected {want}")
    print(f"runners (phase 45): {json.dumps(out)}", flush=True)
    return out


def ik_problem(name, dev, seed=0):
    """An IK call of ``name``'s body (``ik_kernel.palm_ik``'s operands):
    the reset posture with the arm nudged by a seeded normal, the target
    8-15 cm off the palm."""
    from ppi_tpu_torch.runners.run_mpc import ENVS
    cfg = IK_BODIES[name]
    env = ENVS[name]()
    s = env.reset(torch.Generator(dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    q = s.physics.qpos.clone()
    q[:4] += torch.from_numpy(
        (0.1 * rng.standard_normal(4)).astype(np.float32)).to(dev)
    dyn = getattr(s, "frame", getattr(s, "board", None))
    target = env._sites_soa(q, dyn)[env._palm_geom] + torch.tensor(
        [0.08, -0.04, 0.12], device=dev)
    n = cfg["n_var"]
    lo, hi = env.action_low.to(dev)[:n], env.action_high.to(dev)[:n]
    return env, (q[:n].clone(), q[n:].clone(), target, lo, hi), dyn


def ik_bound(env, name, iters):
    """(ops bound ms, chain bound ms) of one IK call of ``iters``."""
    from ppi_tpu_torch.envs.physics import ik_kernel as ik
    cfg = IK_BODIES[name]
    spec = (env._model, env._palm_geom, cfg["n_var"],
            getattr(env, "scalar_dyn_body", None), cfg["level"] is not None)
    ops = ik.ops_per_iteration(*spec) * iters
    chain = ik.chain_per_iteration(*spec) * iters
    # no bytes to speak of: x0, q, the target and the box in, x out
    return least_time(ops, 4 * 64)[0], 1e3 * chain * CHAIN_CYCLES / SM_HZ


def check_and_time_ik(name, dev):
    """Phase 46's kernel part for one body: the kernel against the plain
    version at IK_CHECK_ITERS; the kernel's time at each of its expert's
    iteration counts and at IK_PLAIN_ITERS, the plain version's there
    (both through ``palm_ik``, CUDA events); the bounds."""
    from ppi_tpu_torch.envs.physics import ik_kernel as ik
    cfg = IK_BODIES[name]
    env, args, dyn = ik_problem(name, dev)
    w, lr = cfg["level"], cfg["lr"]
    got = ik.palm_ik(env, *args, IK_CHECK_ITERS, lr, w, dyn)
    ref = ik.plain_palm_ik(env, *args, IK_CHECK_ITERS, lr, w, dyn)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(bool(torch.isfinite(ref).all()) and err <= IK_TOL,
          f"phase 46: {name} IK kernel vs plain {err} > {IK_TOL}")
    nan_target = torch.full((3,), float("nan"), device=dev)
    nan_out = ik.palm_ik(env, args[0], args[1], nan_target, *args[3:], 3,
                         lr, w, dyn)
    check(bool(torch.isnan(nan_out).all()),
          f"phase 46: {name} IK kernel: a NaN target came back {nan_out}")
    out = {"max_abs_err": err, "check_iters": IK_CHECK_ITERS}
    for iters in sorted(set(cfg["iters"]) | {IK_PLAIN_ITERS}):
        out[f"kernel_ms_iters{iters}"] = cuda_ms(
            lambda: ik.palm_ik(env, *args, iters, lr, w, dyn), 3, warmup=1)
        out[f"bound_ms_iters{iters}"], out[f"chain_ms_iters{iters}"] = \
            ik_bound(env, name, iters)
    # one call: the check above warmed the plain version
    out[f"plain_ms_iters{IK_PLAIN_ITERS}"] = cuda_ms(
        lambda: ik.plain_palm_ik(env, *args, IK_PLAIN_ITERS, lr, w, dyn),
        1, warmup=0)
    out["plain_ms_per_iteration"] = (out[f"plain_ms_iters{IK_PLAIN_ITERS}"]
                                     / IK_PLAIN_ITERS)
    return out


def run_expert(name, fn, env, state0, ik_calls, **kw):
    """One scripted expert on the card from ``state0`` with its log and
    frames; (final state, info, report): its wall, the rollout and IK
    launches (counted from zero) against its own record: one launch a
    step of its frames (``steps`` for pen-v0-hand), ``ik_calls(log)``
    IK launches."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import ik_kernel as ik
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    log, frames = [], []
    key = rk.launch_key(env)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    if name.startswith("pen"):
        state, info = fn(env, state0, **kw)
        steps = info["similarity"].shape[0]
    else:
        extra = {} if name.startswith("relocate-v0-hand") else {"log":
                                                              log.append}
        state, info = fn(env, state0, frames=frames, **extra, **kw)
        steps = sum(f.shape[0] for f in frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = {"wall_s": wall, "steps": steps, "launches": LAUNCHES[key],
           "ik_launches": LAUNCHES[ik.LAUNCH_KEY],
           "ik_calls": ik_calls(log)}
    check(rep["launches"] == steps and sum(LAUNCHES.values())
          == steps + rep["ik_launches"],
          f"phase 46: {name}: {dict(LAUNCHES)} launches for {steps} steps")
    check(rep["ik_launches"] == rep["ik_calls"],
          f"phase 46: {name}: {rep['ik_launches']} IK launches, expected "
          f"{rep['ik_calls']}")
    return state, info, rep, log


def expert_phase(dev, ik_builds):
    """Phase 46: the five IK bodies' builds, checks and times, then the
    seven scripted experts whole on the card to the JAX tests' gates."""
    from ppi_tpu_torch.convert import KEY0_DOOR_FRAME, KEY0_HAMMER_BOARD
    from ppi_tpu_torch.envs import (
        door_adroit, door_hand, hammer_adroit, hammer_hand, pen_hand,
        relocate_adroit, relocate_hand)
    from ppi_tpu_torch.envs.relocate import BALL_RADIUS, TABLE_Z
    out = {"builds": {}, "ik": {}, "experts": {}}
    for name, fut in ik_builds.items():
        lib, secs = fut.result()
        out["builds"][name] = {"nvcc_s": secs,
                               "ptxas": ptxas_summary(lib)}
        print(f"ik build {name}: nvcc {secs:.1f} s; ptxas: "
              f"{' | '.join(out['builds'][name]['ptxas'])}", flush=True)
    for name in IK_BODIES:
        out["ik"][name] = check_and_time_ik(name, dev)
        print(f"ik {name}: {json.dumps(out['ik'][name])}", flush=True)

    def count(prefix):
        return lambda log: sum(m.startswith(prefix) for m in log)

    gates = {}
    # door-v0-hand on JAX's key(0) frame (tests/test_door_hand.py:71-81)
    env = door_hand.DoorHand()
    st, info, rep, log = run_expert(
        "door-v0-hand", door_hand.scripted_open, env,
        env.reset(None, dev, frame=KEY0_DOOR_FRAME),
        lambda log: 1 + count("sweep:")(log), device=dev)
    gates["door-v0-hand"] = (info["success"] and info["door"] > 1.35, info,
                             rep, log)
    env = door_adroit.DoorAdroit(fixed_scene=True)
    st, info, rep, log = run_expert(
        "door-v0-adroit", door_adroit.scripted_open, env, None,
        lambda log: 1 + count("sweep:")(log), device=dev)
    gates["door-v0-adroit"] = (info["success"], info, rep, log)
    for name, mod, cls in (
            ("relocate-v0-hand", relocate_hand, relocate_hand.RelocateHand),
            ("relocate-v0-adroit", relocate_adroit,
             relocate_adroit.RelocateAdroit)):
        env = cls(fixed_goal=True)
        st, info, rep, log = run_expert(
            name, mod.scripted_carry, env, None,
            (lambda log: 0) if name == "relocate-v0-hand"
            else (lambda log: 3 * count("wp")(log)), device=dev)
        ball = env._sites(st.physics.qpos)[2]
        info["ball_z"] = float(ball[2])
        gates[name] = (info["success"]
                       and info["ball_z"] > TABLE_Z + BALL_RADIUS + 0.1,
                       info, rep, log)
    # hammer-v0-hand on the fixed board and on JAX's key(0) board
    # (tests/test_hammer_hand.py:60-77, 154-165)
    for name, env, state0 in (
            ("hammer-v0-hand", hammer_hand.HammerHand(fixed_scene=True),
             None),
            ("hammer-v0-hand raised", hammer_hand.HammerHand(),
             hammer_hand.HammerHand().reset(None, dev,
                                            board=KEY0_HAMMER_BOARD))):
        demo = []
        st, info, rep, log = run_expert(
            name, hammer_hand.scripted_hammer, env, state0,
            lambda log: 2 + sum("re-hover" in m for m in log),
            actions=demo, device=dev)
        rep["demo_actions"] = list(np.concatenate(demo).shape)
        check(rep["demo_actions"] == [rep["steps"], env.action_dim],
              f"phase 46: {name}: actions log {rep['demo_actions']}")
        lifted = [float(m.split("=")[1]) for m in log if "lifted" in m]
        info["lifted"] = lifted[0] if lifted else None
        ok = info["success"] and info["nail"] > 0.95 * hammer_hand.NAIL_DEPTH
        if name == "hammer-v0-hand":
            ok = ok and abs(info["hammer_x"]) < 0.3 and lifted \
                and lifted[0] > 0.03
        gates[name] = (ok, info, rep, log)
    env = hammer_adroit.HammerAdroit(fixed_scene=True)
    st, info, rep, log = run_expert(
        "hammer-v0-adroit", hammer_adroit.scripted_hammer_adroit, env, None,
        lambda log: 2 + count("align")(log) + count("press")(log),
        device=dev)
    carried = [float(m.split("ham_z=")[1]) for m in log if "carried" in m]
    info["carried_ham_z"] = carried[0] if carried else None
    gates["hammer-v0-adroit"] = (
        info["success"] and info["nail"] > 0.95 * hammer_hand.NAIL_DEPTH
        and bool(carried) and carried[0] > 0.1, info, rep, log)
    env = pen_hand.PenHand(fixed_goal=True)
    s0 = env.reset(None, dev)
    _, ax0 = env._pen_pose(s0.physics.qpos)
    sim0 = float(torch.dot(ax0, s0.target_axis))
    st, info, rep, log = run_expert(
        "pen-v0-hand", pen_hand.scripted_reorient, env, s0, lambda log: 0)
    info["start_similarity"] = sim0
    gates["pen-v0-hand"] = (
        info["final_similarity"] > 0.85
        and info["max_similarity"] > sim0 + 0.05 and not info["dropped"],
        info, rep, log)

    ik_of = {"door-v0-hand": "door-v0-hand",
             "door-v0-adroit": "door-v0-adroit",
             "hammer-v0-hand": "hammer-v0-hand",
             "hammer-v0-hand raised": "hammer-v0-hand",
             "hammer-v0-adroit": "hammer-v0-adroit",
             "relocate-v0-adroit": "relocate-v0-adroit"}
    for name, (ok, info, rep, log) in gates.items():
        info = {k: (v.tolist() if isinstance(v, (torch.Tensor, np.ndarray))
                    else v) for k, v in info.items() if k != "similarity"}
        if name in ik_of:
            # the expert's IK at its counts: the kernel's measured time a
            # call, the plain version's a measured iteration x the count
            t = out["ik"][ik_of[name]]
            iters = IK_BODIES[ik_of[name]]["iters"]
            calls = ([1, rep["ik_calls"] - 1] if len(iters) == 2
                     else [rep["ik_calls"]])
            rep["ik_iterations"] = sum(c * i for c, i in zip(calls, iters))
            rep["ik_kernel_ms"] = sum(c * t[f"kernel_ms_iters{i}"]
                                      for c, i in zip(calls, iters))
            rep["ik_plain_ms_estimate"] = (rep["ik_iterations"]
                                           * t["plain_ms_per_iteration"])
        out["experts"][name] = {"gate": bool(ok), **rep, **info}
        print(f"expert {name}: {json.dumps(out['experts'][name])}",
              flush=True)
    failed = [n for n, (ok, _, _, log) in gates.items() if not ok]
    check(not failed, f"phase 46: experts below their gates: "
          + "; ".join(f"{n}: {out['experts'][n]} {gates[n][3][-3:]}"
                      for n in failed))
    return out


def collect_phase(tmp):
    """Phase 47: one canonical door-v0 episode through collect_expert;
    returns its report and the npz path."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.runners import collect_expert
    from ppi_tpu_torch.runners.run_mpc import ENVS
    path = Path(tmp) / "door_expert.npz"
    Path(tmp).mkdir(parents=True, exist_ok=True)
    key = rk.launch_key(ENVS["door-v0"]())
    LAUNCHES.clear()
    t0 = time.perf_counter()
    returns = collect_expert.main(collect_expert.build_parser().parse_args(
        COLLECT + ["--out", str(path)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    data = np.load(path)
    shapes_ = {k: list(data[k].shape) for k in data.files}
    rep = {"return": returns[0], "launches": LAUNCHES[key], "wall_s": wall,
           "shapes": shapes_, "door": float(data["observations"][-1, 8]),
           "npz": str(path)}
    check(sorted(data.files) == ["actions", "episode_length",
                                 "observations", "rewards"]
          and shapes_["actions"] == [250, 4] and shapes_["rewards"] == [250]
          and shapes_["observations"][0] == 250
          and int(data["episode_length"]) == 250
          and np.isfinite(data["actions"]).all(),
          f"phase 47: collect_expert npz {shapes_}")
    check(rep["launches"] == 50 + 250 * 2 + 250,
          f"phase 47: {rep['launches']} launches, expected 800")
    print(f"collect_expert (phase 47): {json.dumps(rep)}", flush=True)
    return rep


def sac_phase(tmp, dev):
    """Phase 48: train_sac_expert on humanoid-standup, SAC_CHUNKS chunks
    then SAC_COLLECT steps of the trained policy, through its CLI."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.runners import train_sac_expert as sac_mod
    from ppi_tpu_torch.runners.run_mpc import ENVS
    env = ENVS["humanoid-standup"]()
    Path(tmp).mkdir(parents=True, exist_ok=True)
    out_npz = Path(tmp) / "standup_expert.npz"
    start = sac_mod.SAC(env, device=dev).init(
        torch.Generator(dev).manual_seed(0))
    key = rk.launch_key(env)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    state, history, (obs, act, rew) = sac_mod.main(
        sac_mod.build_parser().parse_args(
            ["--env", "humanoid-standup", "--steps", str(64 * SAC_CHUNKS),
             "--collect-steps", str(SAC_COLLECT), "--seed", "0", "--device",
             "cuda", "--out", str(out_npz)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = max(float((a - b).abs().max()) for a, b in zip(
        state.actor.state_dict().values(), start.actor.state_dict().values()))
    lo, hi = env.action_low.numpy(), env.action_high.numpy()
    data = np.load(out_npz)
    rep = {"chunks": len(history), "critic_loss": [h[0] for h in history],
           "mean_reward": [h[1] for h in history], "moved": moved,
           "return": float(rew.sum()), "launches": LAUNCHES[key],
           "wall_s": wall, "shapes": {k: list(data[k].shape)
                                      for k in data.files}}
    check(len(history) == SAC_CHUNKS
          and all(np.isfinite(h).all() for h in history),
          f"phase 48: SAC losses {history}")
    check(moved > 0.0, "phase 48: the actor's parameters did not move")
    check(bool(((act >= lo - 1e-5) & (act <= hi + 1e-5)).all())
          and np.isfinite(obs).all(), "phase 48: actions out of the box")
    check(rep["launches"] == 64 * SAC_CHUNKS + SAC_COLLECT,
          f"phase 48: {rep['launches']} launches, expected "
          f"{64 * SAC_CHUNKS + SAC_COLLECT}")
    check(rep["shapes"]["actions"] == [SAC_COLLECT, env.action_dim],
          f"phase 48: npz {rep['shapes']}")
    print(f"train_sac_expert (phase 48): {json.dumps(rep)}", flush=True)
    return rep


def render_phase(door, track, state, tmp):
    """Phase 49: phase 4's door-v0 history rendered on the card (the
    schematic to a GIF and an AVI, the ray-caster at 320x240 over every
    frame, its ms a frame and peak memory, 3 of its frames against the
    CPU's and with TF32 allowed), then ``run_mpc --render --render-3d
    --video-format avi`` on a T=RENDER_T door-v0 episode with its exact
    launch count; every file decoded."""
    from ppi_tpu_torch import render, render3d
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.runners import run_mpc
    from ppi_tpu_torch.utils.video import save_gif
    tmp.mkdir(parents=True)
    qpos, frame = track["qpos"], state.frame
    steps = qpos.shape[0]
    res = {}
    for fmt in ("gif", "avi"):
        t0 = time.perf_counter()
        path = render.render_door(door, qpos, tmp / f"door.{fmt}",
                                  frame=frame)
        wall = time.perf_counter() - t0
        n, shape = decoded_frames(path)
        res[f"schematic_{fmt}"] = dict(frames=n, wall_s=wall,
                                       bytes=path.stat().st_size)
        check(n == -(-steps // 2) and shape == (500, 500, 3),
              f"render_door {fmt}: {n} frames of {shape}")
    # the ray-caster over the whole history, twice (the first call the
    # first of its shapes), its peak over what was allocated before
    style = render3d.SceneStyle(floor=0.0)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames = render3d.render_trajectory(door, qpos, dyn_pos=frame,
                                            style=style)
        times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - before
    chunk = render3d.frames_per_chunk(door._model, render3d.Camera(),
                                      render3d.scene_arrays(door._model)[0])
    check(frames.shape == (steps, 240, 320, 3) and frames.dtype == np.uint8,
          f"render_trajectory: {frames.shape} {frames.dtype}")
    check(peak <= render3d.MEMORY_BUDGET, f"render_trajectory: peak "
          f"{peak} B over the {render3d.MEMORY_BUDGET} B budget")
    t0 = time.perf_counter()
    path = save_gif(tmp / "door_3d.gif", list(frames))
    gif_s = time.perf_counter() - t0
    n, shape = decoded_frames(path)
    check(n == steps and shape == (240, 320, 3),
          f"door_3d.gif: {n} frames of {shape}")
    idx = [0, steps // 2, steps - 1]
    cpu = render3d.render_trajectory(door, qpos[idx].cpu(),
                                     dyn_pos=frame.cpu(), style=style,
                                     device="cpu")
    diff = np.abs(cpu.astype(int) - frames[idx].astype(int)).max(-1)
    off = float((diff > 1).mean())
    check(off <= 0.005, f"render_trajectory: {off:.4f} of the pixels off "
          "the CPU's frames by more than 1 level")
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = render3d.render_trajectory(door, qpos[idx], dyn_pos=frame,
                                          style=style)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
    check(np.array_equal(tf32, frames[idx]),
          "render_trajectory: TF32 allowed changed the frames")
    res["ray_caster"] = dict(
        frames=steps, width=320, height=240, frames_a_chunk=chunk,
        ms_a_frame=[1e3 * t / steps for t in times],
        peak_bytes_over_before=peak,
        peak_bytes=torch.cuda.max_memory_allocated(),
        budget_bytes=render3d.MEMORY_BUDGET, gif_s=gif_s,
        vs_cpu_off_by_more_than_1=off, vs_cpu_max_level=int(diff.max()),
        tf32_allowed_equal=True)
    print(f"render door-v0 (phase 4's {steps} steps): schematic gif "
          f"{json.dumps(res['schematic_gif'])}, avi "
          f"{json.dumps(res['schematic_avi'])}; ray-caster 320x240 "
          f"{json.dumps(res['ray_caster'])}", flush=True)
    # the runner's flags on a short episode
    argv = door_run_argv(tmp / "mpc", "--render", "--render-3d",
                         "--video-format", "avi", timesteps=RENDER_T)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, _ = run_mpc.main(run_mpc.build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    launches = LAUNCHES[rk.launch_key(door)]
    (run_dir,) = (tmp / "mpc").iterdir()
    names = {p.name for p in run_dir.iterdir()}
    want = {"args.json", "log", "data.npz", "episode.avi", "episode_3d.gif",
            "result_warmup.png", "observation_sequence.png",
            "action_sequence_all.png", "ess_history.png",
            "alpha_history.png", "smoothness.png"}
    check(names == want, f"run_mpc --render --render-3d: wrote {sorted(names)}")
    check(launches == 50 + 3 * RENDER_T, f"run_mpc --render: {launches} "
          f"launches, expected {50 + 3 * RENDER_T}")
    check("rendering failed" not in (run_dir / "log").read_text(),
          "run_mpc --render: a render failed (see its log)")
    counts = {name: decoded_frames(run_dir / name)[0] for name in want
              if name.endswith((".avi", ".gif", ".png"))}
    check(counts["episode.avi"] == RENDER_T // 2
          and counts["episode_3d.gif"] == RENDER_T,
          f"run_mpc --render: frames {counts}")
    res["run_mpc"] = dict(ret=ret, success=success, launches=launches,
                          wall_s=wall, frames=counts)
    print(f"run_mpc --render --render-3d --video-format avi (door-v0, "
          f"T={RENDER_T}): {json.dumps(res['run_mpc'])}", flush=True)
    return res


def figures_phase(tmp):
    """Phase 50: ``run_opt --plot`` through the moment-match kernel, the
    paper figures and the animations at reduced frame counts, on the
    card; every file decoded with its frame count."""
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.runners import animations, figures, run_opt
    res = {}
    LAUNCHES.clear()
    t0 = time.perf_counter()
    _, trace = run_opt.main(run_opt.build_parser().parse_args(
        PLOT_OPT[:-3] + ["--dir", str(tmp / "opt")] + PLOT_OPT[-3:]))
    torch.cuda.synchronize()
    (run_dir,) = (tmp / "opt").iterdir()
    decoded_frames(run_dir / "result.png")
    res["run_opt"] = dict(launches=LAUNCHES["moment_match"],
                          wall_s=time.perf_counter() - t0,
                          first=float(trace["mean"][0]),
                          final=float(trace["mean"][-1]))
    check(res["run_opt"]["launches"] == 10, f"run_opt --plot: "
          f"{res['run_opt']['launches']} moment-match launches, expected 10")
    t0 = time.perf_counter()
    figures.main(figures.build_parser().parse_args(
        ["--out", str(tmp / "fig")]))
    for name in ("gaussian_ppi.png", "gp_receding_horizon.png",
                 "trajectory_priors.png"):
        decoded_frames(tmp / "fig" / name)
    res["figures_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = tmp / "anim"
    out.mkdir()
    made = {animations.anim_gaussian_ppi(out, 8, "cuda"): 8,
            animations.anim_nonlinear_ppi(out, 2, "cuda"): 6,
            animations.anim_policy_time_shift(out, 6, "cuda"): 6,
            animations.anim_policy_time_resolution(out, 4, "cuda"): 4}
    res["animations"] = {p.name: decoded_frames(p)[0] for p in made}
    res["animations_s"] = time.perf_counter() - t0
    check(all(res["animations"][p.name] == n for p, n in made.items()),
          f"animations: frames {res['animations']}")
    print(f"run_opt --plot, figures, animations: {json.dumps(res)}",
          flush=True)
    return res


def main():
    # one nvcc for each source, all started together
    with ThreadPoolExecutor(max_workers=32) as pool:
        return run(pool)


def run(pool):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    t_start = time.perf_counter()
    # f32 everywhere: TF32 matmuls and convolutions off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = {"card": smi, "device": kind}
    # each phase's seconds, from its marker to the next (phase 0: the
    # imports and nvidia-smi); printed before the kernels line
    phase_s, lap = {}, ["0", t_start]

    def mark_phase(name):
        now = time.perf_counter()
        phase_s[lap[0]] = now - lap[1]
        lap[:] = [name, now]

    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.base import risk_aggregate
    from ppi_tpu_torch.envs.door import DOOR, Door
    from ppi_tpu_torch.envs.functions import make_function
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.ops import m_projection
    from ppi_tpu_torch.ops.cuda_ops import (
        m_projection_cuda, m_projection_plain)
    from ppi_tpu_torch.policies.gaussian import Gaussian
    from ppi_tpu_torch.runners import run_mpc, run_opt
    from ppi_tpu_torch.runners.run_mpc import ENVS
    from ppi_tpu_torch.studies.moment_match import launch_device_us

    # ---- 1. build (both kernels, in parallel) ------------------------------
    mark_phase("1")
    door = Door(fixed_scene=True)
    t0 = time.perf_counter()
    # phase 25's three bodies are the largest (nvcc ~1 min each): they
    # start first, with phase 32's eight warp-layout bodies
    warp_bodies = {name: warp_header(ENVS[name]()) for name in WARP}
    warp_builds = {name: pool.submit(build_timed, "rollout_warp.cu",
                                     {"env_warp.h": h})
                   for name, h in warp_bodies.items()}
    # phase 35's split bodies (each generated in its thread, a few seconds),
    # and the warp bodies phase 37 times beside them
    split_builds = {name: pool.submit(split_build, ENVS[name]())
                    for name in SPLIT}
    for name, cfg in SPLIT.items():
        if cfg.get("warp"):
            pool.submit(build_timed, "rollout_warp.cu",
                        {"env_warp.h": warp_header(ENVS[name]())})
    bodies = {name: env_header(ENVS[name]()) for name in ADROIT}
    body_builds = {name: pool.submit(build_timed, "rollout.cu",
                                     {"env_body.h": h})
                   for name, h in bodies.items()}
    header = rk.generate_env_header(
        door._model, door.dt, door.substeps, door.action_dim,
        door.scalar_torque, door.scalar_reward, door.scalar_dyn_body)
    rollout_build = pool.submit(build_timed, "rollout.cu",
                                {"env_body.h": header})
    mm_build = pool.submit(build_timed, "moment_match.cu")
    # phase 38's ball-in-a-cup kernel in both layouts (each body generated
    # in ~0.1 s; the one-thread layout's nvcc ~160 s)
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    bic_headers = {"thread": bk.generate_bic_header(BallInCupSim()),
                   "warp": bk.generate_warp_header(BallInCupSim())}
    bic_builds = {lay: pool.submit(build_timed, bk.SOURCES[lay][0],
                                   {bk.SOURCES[lay][1]: h})
                  for lay, h in bic_headers.items()}
    # phase 46's five palm-IK bodies (each generated in ~0.1 s)
    from ppi_tpu_torch.envs.physics import ik_kernel
    ik_builds = {
        name: pool.submit(build_timed, ik_kernel.SOURCE, {
            ik_kernel.HEADER: ik_kernel.env_header(
                ENVS[name](), cfg["n_var"], cfg["level"] is not None)})
        for name, cfg in IK_BODIES.items()}
    # phase 9's bodies build beside phases 1 and 5, and phase 13's, 17's
    # and 21's: all twenty-two builds at once
    rest = {name: env_header(ENVS[name]())
            for name in (*VARIANT_B, *HAND, *SCENES, *REST)}
    body_builds.update({name: pool.submit(build_timed, "rollout.cu",
                                          {"env_body.h": h})
                        for name, h in rest.items()})
    bodies.update(rest)
    lib, _ = rollout_build.result()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(lib)
    print(f"build: {build_s:.1f} s, {len(header.splitlines())} generated "
          f"lines; ptxas: {' | '.join(ptxas)}", flush=True)
    out.update(build_s=build_s, ptxas=ptxas)

    def make_run(horizon, d=door):
        return rk.make_rollout(d._model, d.dt, d.substeps, horizon,
                               d.action_dim, d.scalar_torque,
                               d.scalar_reward, dyn_body=DOOR)

    # ---- 2. kernel vs plain ----------------------------------------------------
    mark_phase("2")
    # the objectives below launch door-v0's routed layout: its build first
    split_builds["door-v0"].result()
    rng = np.random.default_rng(0)
    acts = torch.from_numpy((0.4 * rng.standard_normal(
        (N_CHECK, H_CHECK, door.action_dim))).astype(np.float32)).to(dev)
    s0 = door.reset(None, dev)
    q0, qd0 = lanes(s0, N_CHECK)
    run = make_run(H_CHECK)
    rew, qf, qdf = run(q0, qd0, acts, dyn=s0.frame)
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(door, s0, q0, qd0, acts)
    torch.cuda.synchronize()
    check(rew.shape == (N_CHECK, H_CHECK) and qf.shape == (N_CHECK, 6),
          f"output shapes {tuple(rew.shape)}, {tuple(qf.shape)}")
    errs = {"rewards": rel_err(rew, rew_p), "qf": rel_err(qf, qf_p),
            "qdf": rel_err(qdf, qdf_p)}
    max_abs = max(float((a - b).abs().max())
                  for a, b in ((rew, rew_p), (qf, qf_p), (qdf, qdf_p)))
    check(max(errs.values()) <= TOL, f"kernel vs plain {errs} > {TOL}")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, dyn=s0.frame)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          "a NaN lane must go NaN alone")

    mask = (torch.arange(H_CHECK, device=dev) < H_CHECK - 5).float()
    c_k = rk.kernel_mpc_objective(door, s0, H_CHECK, mask)(None, acts)
    c_p = risk_aggregate(rew_p, mask)
    c_full = rk.kernel_mpc_objective(door, s0, H_CHECK)(None, acts)
    errs["masked_costs"] = rel_err(c_k, c_p)
    check(errs["masked_costs"] <= TOL
          and bool(torch.allclose(c_k, -(rew * mask).sum(1)))
          and not bool(torch.allclose(c_k, c_full)),
          f"horizon mask: {errs['masked_costs']}")

    sampled = Door()
    s1 = sampled.reset(torch.Generator(dev).manual_seed(1), dev)
    check(not bool(torch.equal(s1.frame, s0.frame)), "frame not sampled")
    c_k1 = rk.kernel_mpc_objective(sampled, s1, H_CHECK)(None, acts)
    c_p1 = risk_aggregate(rk.env_plain_rollout(
        sampled, s1, *lanes(s1, N_CHECK), acts)[0])
    errs["sampled_frame_costs"] = rel_err(c_k1, c_p1)
    check(errs["sampled_frame_costs"] <= TOL
          and not bool(torch.allclose(c_k1, c_full)),
          f"sampled frame: {errs['sampled_frame_costs']}")
    print(f"check: N={N_CHECK} H={H_CHECK} errors {json.dumps(errs)} "
          f"(tol {TOL}); max abs err {max_abs:.3g}; NaN lane isolated; "
          f"mask and sampled frame applied", flush=True)
    out.update(check_errors=errs, max_abs_err=max_abs)
    # phase 36 holds the split layout to the lane kernel on these lanes
    CHECKED["door-v0"] = dict(s0=s0, q0=q0, qd0=qd0, acts=acts, s1=s1,
                              h_frame=H_FRAME, plain=(rew_p, qf_p, qdf_p))

    # ---- 3. timings ------------------------------------------------------------
    mark_phase("3")
    timings = {}
    for n, h, iters in ((1024, 160, 20), (64, 30, 200), (1024, 20, 20)):
        a = torch.from_numpy((0.4 * rng.standard_normal(
            (n, h, door.action_dim))).astype(np.float32)).to(dev)
        qn, qdn = lanes(s0, n)
        r = make_run(h)
        timings[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
            lambda: r(qn, qdn, a, dyn=s0.frame), iters)
    # the plain rollout at H=20: one eager op per scalar op, ~19 s at H=160
    a = torch.from_numpy((0.4 * rng.standard_normal(
        (1024, 20, door.action_dim))).astype(np.float32)).to(dev)
    qn, qdn = lanes(s0, 1024)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.env_plain_rollout(door, s0, qn, qdn, a)
    torch.cuda.synchronize()
    timings["plain_ms_N1024_H20"] = 1e3 * (time.perf_counter() - t0)

    timings["ppi_iter_ms_N1024_H160"], stats = time_ppi(
        door, s0, rk.kernel_mpc_objective(door, s0, 160), 1024, 160, 20)
    check(bool(torch.isfinite(stats["mean"])), "PPI iteration cost not finite")
    print(f"timings: {json.dumps(timings)}", flush=True)
    out.update(timings=timings)

    # ---- 4. the canonical episode ----------------------------------------------
    mark_phase("4")
    args = run_mpc.build_parser().parse_args(door_args(250))
    final4 = {}   # the final env state, which phase 43 is held to
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(
        args, lambda t, state, row: final4.update(state=state))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES[rk.launch_key(door)]
    expected = 50 + 250 * 2 + 250   # each real step is a launch too
    check(np.isfinite(ret), f"episode return {ret}")
    check(track["action"].shape == (250, door.action_dim)
          and bool(torch.isfinite(track["action"]).all()),
          "episode actions not finite")
    check(launches == expected, f"{launches} kernel launches, expected "
          f"{expected}")
    check(success, f"door not open (return {ret:.2f})")
    print(f"episode: return {ret:.2f}, success {success}, {launches} kernel "
          f"launches, wall {wall:.1f} s", flush=True)
    out.update(episode_return=ret, episode_success=success,
               episode_wall_s=wall, episode_launches=launches)

    # ---- 5. build the moment-match kernel ---------------------------------------
    mark_phase("5")
    mm_lib, mm_build_s = mm_build.result()
    mm_ptxas = ptxas_by_kernel(mm_lib)
    # the tensor cores' wgmma instructions in the main kernel's SASS
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(mm_lib)], capture_output=True, text=True,
                          check=True).stdout
    mm_hgmma = len(re.findall(r"\bHGMMA\.", sass))
    check(mm_hgmma > 0, "no HGMMA instruction in the moment-match kernels")
    print(f"mm build: {mm_build_s:.1f} s (in parallel with phase 1); "
          f"ptxas: {json.dumps(mm_ptxas)}; {mm_hgmma} HGMMA instructions in "
          "the SASS", flush=True)
    out.update(mm_build_s=mm_build_s, mm_ptxas=mm_ptxas, mm_hgmma=mm_hgmma)

    # ---- 6. moment match: kernel vs plain vs float64 oracle ----------------------
    mark_phase("6")
    def mm_inputs(n, d, seed, masked_q=0, offset=0.0, one_lane=False):
        g = torch.Generator(dev).manual_seed(seed)
        x = offset + torch.randn(n, d, generator=g, device=dev)
        # heavy-tailed log-weights: scale 3, weights over e^+-9
        lw = 3.0 * torch.randn(n, generator=g, device=dev)
        lw[torch.randperm(n, generator=g, device=dev)[:n * masked_q // 4]] \
            = -torch.inf
        if one_lane:
            lw = torch.full((n,), -torch.inf, device=dev)
            lw[n // 3] = 0.0
        return lw, x

    cases = [(f"4096x64_masked{q}q", (4096, 64, 10 + q, q)) for q in range(4)]
    cases += [("4000x640", (4000, 640, 20)), ("1000x17", (1000, 17, 21)),
              ("256x9_offset100", (256, 9, 22, 0, 100.0)),
              ("512x64_one_lane", (512, 64, 23, 0, 0.0, True))]
    mm_errs, mm_max_abs = {}, 0.0
    for case, args_ in cases:
        lw, x = mm_inputs(*args_)
        k = m_projection_cuda(lw, x)
        p = m_projection_plain(lw, x)
        o = oracle_moments(lw, x)
        torch.cuda.synchronize()
        kp = [float((a - b).abs().max()) for a, b in zip(k[:2], p[:2])]
        ess_rel = abs(float(k[2]) - float(p[2])) / float(p[2])
        mm_max_abs = max(mm_max_abs, *kp, abs(float(k[2]) - float(p[2])))
        check(max(kp) <= MM_TOL and ess_rel <= MM_TOL,
              f"moment match {case}: kernel vs plain {kp}, ESS {ess_rel}")
        for label, (mu, sigma, ess) in (("kernel", k), ("plain", p)):
            mu_err = float((mu.double() - o[0]).abs().max())
            sig_ok = bool(((sigma.double() - o[1]).abs()
                           <= ORACLE_SIGMA_ATOL
                           + ORACLE_SIGMA_RTOL * o[1].abs()).all())
            ess_err = abs(float(ess) - float(o[2])) / float(o[2])
            check(mu_err <= ORACLE_MU_ATOL and sig_ok
                  and ess_err <= ORACLE_ESS_RTOL,
                  f"moment match {case}: {label} vs oracle mu {mu_err}, "
                  f"sigma ok {sig_ok}, ESS {ess_err}")
            if case.endswith("offset100"):
                diag = torch.diagonal(sigma).double()
                check(bool(((diag - torch.diagonal(o[1])).abs()
                            <= 0.05 * torch.diagonal(o[1]).abs()).all()),
                      f"moment match {case}: {label} lost the covariance")
        if case.endswith("one_lane"):
            check(float(k[2]) == 1.0, f"one live lane: ESS {float(k[2])}")
        check(bool(torch.equal(k[1], k[1].T)),
              f"moment match {case}: sigma not exactly symmetric")
        mm_errs[case] = {"kernel_vs_plain": kp, "ess_rel": ess_rel}
        print(f"mm check {case}: kernel vs plain mu/sigma {kp[0]:.3g}/"
              f"{kp[1]:.3g}, ESS rel {ess_rel:.3g}", flush=True)
    lw, x = mm_inputs(4000, 640, 20)
    first = m_projection_cuda(lw, x)
    again = m_projection_cuda(lw, x)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two launches on one input differ")
    print(f"mm check: all within {MM_TOL} of plain and the oracle bounds; "
          f"max abs err {mm_max_abs:.3g}; repeat launches bit-identical",
          flush=True)
    out.update(mm_check=mm_errs, mm_max_abs_err=mm_max_abs)

    # ---- 7. moment-match timings -------------------------------------------------
    mark_phase("7")
    mm_times = {}
    for n, d in ((100, 20), (4096, 64), (4096, 640), (16384, 640)):
        lw, x = mm_inputs(n, d, 30)
        for label, fn in (
                ("kernel", m_projection_cuda),
                ("plain", m_projection_plain),
                ("two_pass", lambda l, s: m_projection(l, s, "never"))):
            mm_times[f"{label}_ms_{n}x{d}"] = cuda_ms(lambda: fn(lw, x), 50)
    # the library's nearest single call, the weighted covariance alone, in
    # turns with the kernel (kernel, cov, cov, kernel)
    lw, x = mm_inputs(4096, 640, 30)
    w = torch.exp(lw - lw.max())
    turns = {"kernel": lambda: m_projection_cuda(lw, x),
             "cov": lambda: torch.cov(x.T, correction=0, aweights=w)}
    mm_times["turns_ms_4096x640"] = [
        [label, cuda_ms(turns[label], 50)]
        for label in ("kernel", "cov", "cov", "kernel")]
    mm_times["library_ms_4096x640"] = float(np.mean(
        [ms for label, ms in mm_times["turns_ms_4096x640"]
         if label == "cov"]))
    # each of the wrapper's three launches, device time from the profiler
    mm_times["launch_us_4096x640"] = launch_device_us(turns["kernel"], 20)
    # the function's work: the upper triangle of S2 (one FMA per sample and
    # pair), S1, the weights, over the f32 SIMT peak; each input read once,
    # mu, sigma and ESS written once
    n, d = 4096, 640
    mm_bytes = 4 * (n * d + n + d * d + d + 1)
    mm_times["bound_ms_4096x640"], mm_bound_by = least_time(
        n * d * (d + 1) + 2 * n * d + 4 * n, mm_bytes)
    # the landed design's: three TF32 products a term of the same upper
    # triangle, with S1 and the weights, over the TF32 tensor-core peak
    mm_times["bound_tc_ms_4096x640"], mm_bound_tc_by = least_time(
        3 * n * d * (d + 1) + 2 * n * d + 4 * n, mm_bytes, PEAK_TF32_FLOPS)
    d, n = 640, 4096
    fam = Gaussian(dim=d)
    state = fam.init(torch.ones(d, device=dev),
                     0.5 * torch.eye(d, device=dev))
    step = _one_iteration(make_solver("Reps"), fam,
                          make_function("NoisySphere", d), n)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    mm_times["opt_iter_ms_d640_N4096"] = 1e3 * (time.perf_counter() - t0) / 20
    check(bool(torch.isfinite(stats["mean"])), "opt iteration not finite")
    print(f"mm timings: {json.dumps(mm_times)}", flush=True)
    out.update(mm_timings=mm_times)

    # ---- 8. black-box runs through run_opt ---------------------------------------
    mark_phase("8")
    runs, mm_launches = {}, 0
    for dim, n_samples, expected, bound in RUNS:
        args = run_opt.build_parser().parse_args([
            "Reps", "NoisySphere", "--dimension", str(dim), "--n-iter", "50",
            "--seed", "0", "--device", "cuda", "mc", "--n-samples",
            str(n_samples)])
        LAUNCHES.clear()
        t0 = time.perf_counter()
        state, trace = run_opt.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = LAUNCHES["moment_match"]
        mm_launches += got
        first, final = float(trace["mean"][0]), float(trace["mean"][-1])
        limit = FINAL_RATIO * first if bound == "ratio" else bound
        check(got == expected, f"run d={dim}: {got} kernel launches, "
              f"expected {expected}")
        check(np.isfinite(trace["mean"]).all()
              and bool(torch.isfinite(state.mu).all()),
              f"run d={dim}: non-finite trace or mean")
        check(final <= limit, f"run d={dim}: final cost {final} above "
              f"{limit} (first {first})")
        runs[f"d{dim}_N{n_samples}"] = {"first": first, "final": final,
                                        "launches": got, "wall_s": wall}
        print(f"run d={dim} N={n_samples}: cost {first:.6g} -> {final:.6g} "
              f"(limit {limit:.6g}), {got} kernel launches, wall "
              f"{wall:.2f} s", flush=True)
    out.update(runs=runs)

    # ---- 9. build the variant-(b) bodies -----------------------------------
    mark_phase("9")
    body_info = {}
    for name, fut in body_builds.items():
        if name not in VARIANT_B:
            continue
        body_lib, secs = fut.result()
        info = {"lines": len(bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(body_lib)}
        body_info[name] = info
        print(f"body build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phases 1 and 5); ptxas: "
              f"{' | '.join(info['ptxas'])}", flush=True)
    out.update(bodies=body_info)

    # ---- 10. variant (b): kernel vs plain ------------------------------------
    mark_phase("10")
    for name in VARIANT_B:   # relocate-v0's and cheetah's routed bodies
        if name in SPLIT:
            split_builds[name].result()
    b_errs, b_max_abs = {}, {}
    for name in VARIANT_B:
        b_errs[name], b_max_abs[name] = check_variant_b(name, ENVS[name](),
                                                        dev)
        print(f"check {name}: N={N_CHECK} H={H_EAGER} errors "
              f"{json.dumps(b_errs[name])} (tol {TOL}); max abs err "
              f"{b_max_abs[name]:.3g}; NaN lane isolated; mask applied",
              flush=True)
    out.update(variant_b_check=b_errs, variant_b_max_abs_err=b_max_abs)

    # ---- 11. variant (b): timings --------------------------------------------
    mark_phase("11")
    b_times = {}
    for name in VARIANT_B:
        b_times[name] = time_variant_b(name, ENVS[name](), dev)
        print(f"timings {name}: {json.dumps(b_times[name])}", flush=True)
    timings["bound_ms_N1024_H160"], _ = rollout_bound(door, 1024, 160)
    print(f"door-v0 bound at N=1024/H=160: "
          f"{timings['bound_ms_N1024_H160']:.4g} ms", flush=True)
    out.update(variant_b_timings=b_times)

    # ---- 12. episodes -----------------------------------------------------------
    mark_phase("12")
    episodes = {}
    for name in [*VARIANT_B, "door-v0 cem"]:
        cfg = DOOR_CEM if name == "door-v0 cem" else VARIANT_B[name]
        ret, success, wall, got = run_episode(
            cfg["episode"], cfg["n_samples"],
            key=rk.launch_key(ENVS[cfg["episode"][1]]()))
        episodes[name] = {"return": ret, "success": success,
                          "wall_s": wall, "launches": got}
        print(f"episode {name}: return {ret:.2f}, success {success}, "
              f"{got} kernel launches, wall {wall:.1f} s", flush=True)
        check(np.isfinite(ret), f"{name}: episode return {ret}")
        check(got == cfg["launches"], f"{name}: {got} kernel launches, "
              f"expected {cfg['launches']}")
        if name in ("pen-v0", "relocate-v0"):
            check(success, f"{name}: no success (return {ret:.2f})")
        if name == "cheetah":
            check(ret > 0.0, f"{name}: return {ret:.2f} not above 0")
    out.update(episodes=episodes)

    # ---- 13. build the hand bodies -------------------------------------------
    mark_phase("13")
    for name in HAND:
        body_lib, secs = body_builds[name].result()
        info = {"lines": len(bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(body_lib)}
        body_info[name] = info
        print(f"body build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phases 1-12); ptxas: "
              f"{' | '.join(info['ptxas'])}", flush=True)

    for name in HAND:   # phase 14 launches their warp builds
        warp_builds[name].result()

    # ---- 14. hand bodies: kernel vs plain --------------------------------------
    mark_phase("14")
    hand_errs, hand_max_abs = {}, {}
    for name, cfg in HAND.items():
        hand_errs[name], hand_max_abs[name], clamp = check_hand(
            name, ENVS[name](), dev)
        print(f"check {name}: N={N_CHECK} H={cfg['h_check']} errors "
              f"{json.dumps(hand_errs[name])} (tol {TOL}); max abs err "
              f"{hand_max_abs[name]:.3g}; bolt held {clamp['held']} lanes, "
              f"passed {clamp['passed']}; NaN lane isolated; mask and "
              f"second frame applied; real step matches", flush=True)
    out.update(hand_check=hand_errs, hand_max_abs_err=hand_max_abs)

    # ---- 15. hand bodies: timings -------------------------------------------
    mark_phase("15")
    hand_times = {}
    for name in HAND:
        hand_times[name] = time_hand(name, ENVS[name](), dev)
        print(f"timings {name}: {json.dumps(hand_times[name])}", flush=True)
    out.update(hand_timings=hand_times)

    # ---- 16. hand episodes ------------------------------------------------------
    mark_phase("16")
    hand_episodes = {}
    for name, cfg in HAND.items():
        runs = []
        for seed in cfg["seeds"]:
            ret, success, wall, got = run_episode(
                HAND_EPISODE[:1] + [name] + HAND_EPISODE[1:], 64, seed,
                key=rk.launch_key(ENVS[name]()))
            runs.append({"seed": seed, "return": ret, "success": success,
                         "wall_s": wall, "launches": got})
            print(f"episode {name} seed {seed}: return {ret:.2f}, success "
                  f"{success}, {got} kernel launches, wall {wall:.1f} s",
                  flush=True)
            check(np.isfinite(ret), f"{name} seed {seed}: return {ret}")
            if seed == 0:
                check(got == HAND_LAUNCHES, f"{name}: {got} kernel launches, "
                      f"expected {HAND_LAUNCHES}")
        opened = sum(r["success"] for r in runs)
        check(opened >= cfg["successes"], f"{name}: door opened at {opened} "
              f"of {len(runs)} seeds, expected >= {cfg['successes']}")
        hand_episodes[name] = runs
    out.update(hand_episodes=hand_episodes)

    # ---- 17. build the hammer-v0 and 3-digit hand bodies ----------------------
    mark_phase("17")
    for name in SCENES:
        body_lib, secs = body_builds[name].result()
        info = {"lines": len(bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(body_lib)}
        body_info[name] = info
        print(f"body build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phases 1-16); ptxas: "
              f"{' | '.join(info['ptxas'])}", flush=True)

    for name in SCENES:   # phase 18 launches the warp and split builds
        if name in WARP:
            warp_builds[name].result()
        if name in SPLIT:
            split_builds[name].result()

    # ---- 18. those bodies: kernel vs plain ------------------------------------
    mark_phase("18")
    scene_errs, scene_max_abs = {}, {}
    for name, cfg in SCENES.items():
        scene_errs[name], scene_max_abs[name], moved = check_scene(
            name, ENVS[name](), dev)
        print(f"check {name}: N={N_CHECK} H={cfg['h_check']} errors "
              f"{json.dumps(scene_errs[name])} (tol {SCENE_TOL}); max abs err "
              f"{scene_max_abs[name]:.3g}; contact moved the object in {moved} "
              f"lanes; NaN lane isolated; mask and second board or goal "
              f"applied; real step matches", flush=True)
    out.update(scene_check=scene_errs, scene_max_abs_err=scene_max_abs)

    # ---- 19. those bodies: timings --------------------------------------------
    mark_phase("19")
    scene_times = {}
    for name in SCENES:
        scene_times[name] = time_scene(name, ENVS[name](), dev)
        print(f"timings {name}: {json.dumps(scene_times[name])}", flush=True)
    out.update(scene_timings=scene_times)

    # ---- 20. episodes -------------------------------------------------------------
    mark_phase("20")
    scene_episodes = {}
    for name, cfg in SCENES.items():
        n_samples, last = cfg["shape"][0], {}

        def final(env_state, row, last=last):
            last["qpos"] = env_state.physics.qpos

        runs = []
        for seed in cfg["seeds"]:
            ret, success, wall, got = run_episode(
                cfg["episode"], n_samples, seed, final,
                key=rk.launch_key(ENVS[name]()))
            run_ = {"seed": seed, "return": ret, "success": success,
                    "wall_s": wall, "launches": got}
            if name.startswith("hammer"):
                # the nail's slide is the last coordinate of both scenes
                run_["nail_depth"] = float(last["qpos"][-1])
            if name == "hammer-v0-hand":
                from ppi_tpu_torch.envs.hammer_hand import HAM_Z
                run_["lifted"] = bool(last["qpos"][HAM_Z] > 0.03)
            runs.append(run_)
            print(f"episode {name} seed {seed}: {json.dumps(run_)}",
                  flush=True)
            check(np.isfinite(ret), f"{name} seed {seed}: return {ret}")
            check(got == cfg["launches"], f"{name} seed {seed}: {got} kernel "
                  f"launches, expected {cfg['launches']}")
        done = sum(r["success"] for r in runs)
        check(done >= cfg["successes"], f"{name}: success at {done} of "
              f"{len(runs)} seeds, expected >= {cfg['successes']}")
        scene_episodes[name] = runs
    short = {}
    for prior in OTHER_PRIORS:
        ret, success, wall, got = run_episode(
            ["Lbps", "door-v0", prior, "--delta", "0.9", "--lengthscale",
             "0.08", "--beta", "0.5", "--timesteps", str(T_SHORT)], 64,
            key=rk.launch_key(door))
        short[prior] = {"return": ret, "wall_s": wall, "launches": got}
        print(f"episode door-v0 T={T_SHORT} {prior}: return {ret:.2f}, {got} "
              f"kernel launches, wall {wall:.1f} s", flush=True)
        check(np.isfinite(ret), f"{prior}: return {ret}")
        check(got == 50 + 2 * T_SHORT, f"{prior}: {got} kernel launches, "
              f"expected {50 + 2 * T_SHORT}")
    out.update(scene_episodes=scene_episodes, short_episodes=short)

    # ---- 21. build the remaining variant-(b) bodies ---------------------------
    mark_phase("21")
    for name in REST:
        body_lib, secs = body_builds[name].result()
        info = {"lines": len(bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(body_lib)}
        body_info[name] = info
        print(f"body build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phases 1-20); ptxas: "
              f"{' | '.join(info['ptxas'])}", flush=True)

    for name in REST:   # phase 22 launches the warp and split builds
        if name in WARP:
            warp_builds[name].result()
        if name in SPLIT:
            split_builds[name].result()

    # ---- 22. those bodies: kernel vs plain --------------------------------------
    mark_phase("22")
    rest_errs, rest_max_abs, rest_contact = {}, {}, {}
    for name in REST:
        rest_errs[name], rest_max_abs[name], rest_contact[name] = check_rest(
            name, ENVS[name](), dev)
        print(f"check {name}: N={N_CHECK} H={H_EAGER} errors "
              f"{json.dumps(rest_errs[name])} (tol {TOL}); max abs err "
              f"{rest_max_abs[name]:.3g}; lanes in contact "
              f"{rest_contact[name]}; NaN lane isolated; mask applied; "
              f"actions past the box clipped; real step matches", flush=True)
    out.update(rest_check=rest_errs, rest_max_abs_err=rest_max_abs,
               rest_contact_lanes=rest_contact)

    # ---- 23. those bodies: timings ----------------------------------------------
    mark_phase("23")
    rest_times = {}
    for name in REST:
        rest_times[name] = time_rest(name, ENVS[name](), dev)
        print(f"timings {name}: {json.dumps(rest_times[name])}", flush=True)
    out.update(rest_timings=rest_times)

    # ---- 24. episodes -------------------------------------------------------------
    mark_phase("24")
    rest_episodes = {}
    for name, cfg in REST.items():
        env, last = ENVS[name](), {}
        timesteps = int(cfg["episode"][cfg["episode"].index("--timesteps")
                                       + 1])
        expected = rest_launches(name)

        def final(env_state, row, last=last):
            last["state"] = env_state

        runs = []
        for seed in cfg["seeds"]:
            ret, success, wall, got = run_episode(
                cfg["episode"], cfg["shape"][0], seed, final,
                key=rk.launch_key(env))
            passed, extra = rest_gate(name, env, ret, success,
                                      last["state"], timesteps)
            run_ = {"seed": seed, "return": ret, "success": success,
                    "wall_s": wall, "launches": got, "gate": bool(passed),
                    **extra}
            runs.append(run_)
            print(f"episode {name} seed {seed}: {json.dumps(run_)}",
                  flush=True)
            check(np.isfinite(ret), f"{name} seed {seed}: return {ret}")
            check(got == expected, f"{name} seed {seed}: {got} kernel "
                  f"launches, expected {expected}")
        need = cfg["need"]
        done = sum(r["gate"] for r in runs)
        check(done >= need, f"{name}: gate passed at {done} of {len(runs)} "
              f"seeds, expected >= {need}: {runs}")
        rest_episodes[name] = runs
    out.update(rest_episodes=rest_episodes)

    # ---- 25. build the Adroit-class bodies ----------------------------------
    mark_phase("25")
    for name in ADROIT:
        body_lib, secs = body_builds[name].result()
        info = {"lines": len(bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(body_lib)}
        body_info[name] = info
        print(f"body build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phases 1-24); ptxas: "
              f"{' | '.join(info['ptxas'])}", flush=True)

    for name in ADROIT:   # phase 26 launches the warp builds among them
        if name in WARP:
            warp_builds[name].result()

    # ---- 26. those bodies: kernel vs plain ----------------------------------
    mark_phase("26")
    adroit_errs, adroit_max_abs = {}, {}
    for name, cfg in ADROIT.items():
        adroit_errs[name], adroit_max_abs[name], moved = check_scene(
            name, ENVS[name](), dev, ADROIT, adroit_lanes, adroit_state)
        print(f"check {name}: N={N_CHECK} H={cfg['h_check']} errors "
              f"{json.dumps(adroit_errs[name])} (tol {SCENE_TOL}); max abs "
              f"err {adroit_max_abs[name]:.3g}; contact moved the object in "
              f"{moved} lanes; NaN lane isolated; mask (H={cfg['h_frame']})"
              f" and second board or goal (H={cfg['h_second']}) applied; "
              "real step matches",
              flush=True)
    out.update(adroit_check=adroit_errs, adroit_max_abs_err=adroit_max_abs)

    # ---- 27. those bodies: timings ------------------------------------------
    mark_phase("27")
    adroit_times = {}
    for name in ADROIT:
        adroit_times[name] = time_scene(name, ENVS[name](), dev, ADROIT,
                                        adroit_lanes)
        print(f"timings {name}: {json.dumps(adroit_times[name])}",
              flush=True)
    out.update(adroit_timings=adroit_times)

    # ---- 28. episodes -------------------------------------------------------
    mark_phase("28")
    adroit_episodes = {}
    for name, cfg in ADROIT.items():
        env, last = ENVS[name](), {}

        def final(env_state, row, last=last):
            last["state"] = env_state

        ret, success, wall, got = run_episode(
            cfg["episode"], cfg["shape"][0], 0, final,
            key=rk.launch_key(ENVS[name]()))
        run_ = {"seed": 0, "return": ret, "success": success,
                "wall_s": wall, "launches": got}
        if name == "hammer-v0-adroit":
            from ppi_tpu_torch.envs.hammer_adroit import NAIL
            run_["nail_depth"] = float(last["state"].physics.qpos[NAIL])
            run_["lifted"] = bool(env.lifted(last["state"]))
        adroit_episodes[name] = run_
        print(f"episode {name} seed 0: {json.dumps(run_)}", flush=True)
        check(np.isfinite(ret), f"{name}: return {ret}")
        check(got == cfg["launches"], f"{name}: {got} kernel launches, "
              f"expected {cfg['launches']}")
        if cfg["success"]:
            check(success, f"{name}: no success at seed 0 (return "
                  f"{ret:.2f})")
    out.update(adroit_episodes=adroit_episodes)

    # ---- 29-31. the sharded entry: 4 ranks on the card, 1 nccl rank --------
    mark_phase("29-31")
    # the ranks launch the ball-in-a-cup kernel that phase 1 builds
    for build in bic_builds.values():
        build.result()
    mesh_out, mesh_kernel = sharded_phases(door, dev, out["episode_return"])
    out.update(mesh_out)

    # ---- 32. the warp layout's builds -------------------------------------
    mark_phase("32")
    warp_info = {}
    for name in WARP:
        lib, secs = warp_builds[name].result()
        size = re.search(r"#define PPI_SH_SIZE (\d+)", warp_bodies[name])
        info = {"lines": len(warp_bodies[name].splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(lib),
                "shared_bytes_a_rollout": 4 * int(size.group(1)),
                "shared_bytes_a_block": {
                    w: 4 * int(size.group(1)) * w for w in WARP_SIZES}}
        warp_info[name] = info
        print(f"warp build {name}: {info['lines']} generated lines, nvcc "
              f"{secs:.1f} s (in parallel with phase 1), "
              f"{info['shared_bytes_a_rollout']} B of shared memory a "
              f"rollout, {info['shared_bytes_a_block']} a block of 1-8 "
              f"rollouts; ptxas: "
              f"{' | '.join(info['ptxas'])}; the lane layout's: "
              f"{' | '.join(body_info[name]['ptxas'])}", flush=True)
    out.update(warp_builds=warp_info)

    # ---- 33. the warp layout: bits against plain and the lane layout ------
    mark_phase("33")
    warp_check, warp_err = {}, {}
    for name in WARP:
        warp_check[name], warp_err[name] = check_warp(name, ENVS[name](),
                                                      dev)
        h = CHECKED[name]["acts"].shape[1]
        print(f"check {name} warp layout: N={N_CHECK} H={h} "
              f"{json.dumps(warp_check[name])}; max abs err against plain: "
              f"warp {warp_err[name]['warp']:.3g}, lane "
              f"{warp_err[name]['lane']:.3g}", flush=True)
    out.update(warp_check=warp_check, warp_max_abs_err=warp_err)

    # ---- 34. timings, and the episodes once more through the lane layout --
    mark_phase("34")
    warp_times = {}
    for name in WARP:
        warp_times[name] = time_warp(name, ENVS[name](), dev)
        print(f"timings {name} (lane layout at 128 threads a block, warp "
              f"layout as routed): {json.dumps(warp_times[name])}",
              flush=True)
    out.update(warp_timings=warp_times)
    lane_episodes = {}
    for name in WARP:
        if name in HAND:
            args_list, n_samples = (HAND_EPISODE[:1] + [name]
                                    + HAND_EPISODE[1:]), 64
            warp_run, expected = hand_episodes[name][0], HAND_LAUNCHES
            phase = 16
        elif name in SCENES:
            cfg = SCENES[name]
            args_list, n_samples = cfg["episode"], cfg["shape"][0]
            warp_run, expected = scene_episodes[name][0], cfg["launches"]
            phase = 20
        elif name in REST:   # seed 0 only: one episode holds the returns
            cfg = REST[name]
            args_list, n_samples = cfg["episode"], cfg["shape"][0]
            warp_run = rest_episodes[name][0]
            expected = rest_launches(name)
            phase = 24
        else:
            args_list, n_samples = ADROIT[name]["episode"], \
                ADROIT[name]["shape"][0]
            warp_run, expected = adroit_episodes[name], \
                ADROIT[name]["launches"]
            phase = 28
        with layout_of(type(ENVS[name]()), "lane"):
            ret, success, wall, got = run_episode(args_list, n_samples, 0,
                                                  key="rollout")
        lane_episodes[name] = {"return": ret, "success": success,
                               "wall_s": wall, "launches": got}
        print(f"episode {name} seed 0, lane layout: "
              f"{json.dumps(lane_episodes[name])}; warp layout (phase "
              f"{phase}): return "
              f"{warp_run['return']!r}, wall {warp_run['wall_s']:.1f} s",
              flush=True)
        check(got == expected and warp_run["launches"] == expected,
              f"{name}: {got} and {warp_run['launches']} launches, expected "
              f"{expected}")
        check(ret == warp_run["return"] and success == warp_run["success"],
              f"{name}: lane layout's return {ret!r} ({success}), warp "
              f"layout's {warp_run['return']!r} ({warp_run['success']})")
    check(lane_episodes["door-v0-adroit"]["success"],
          "door-v0-adroit: the door did not open at seed 0")
    check(lane_episodes["pen-v0-adroit"]["success"],
          "pen-v0-adroit: the pen did not reach its goal at seed 0")
    out.update(lane_episodes=lane_episodes)

    # ---- 35. the split layout's builds --------------------------------------
    mark_phase("35")
    split_info = {}
    for name in SPLIT:
        lib, secs, header = split_builds[name].result()
        defs = dict(re.findall(r"#define (PPI_\w+) (\d+)", header))
        info = {"routed": rk.kernel_layout(ENVS[name]()),
                "lines": len(header.splitlines()), "nvcc_s": secs,
                "ptxas": ptxas_summary(lib), "streams": int(defs["PPI_K"]),
                "substep_phases": int(defs["PPI_SUB_PHASES"]),
                "reward_phases": int(defs["PPI_REW_PHASES"]),
                "shared_bytes_a_group": 4 * 32 * int(defs["PPI_SLOTS"])}
        info["lane_ptxas"] = (body_info[name]["ptxas"] if name in body_info
                              else ptxas)   # phase 1 built door-v0's
        split_info[name] = info
        print(f"split build {name} (routed: {info['routed']}): "
              f"{info['lines']} generated lines, nvcc {secs:.1f} s (in "
              f"parallel with phase 1), {info['streams']} warps a group of "
              f"32 rollouts, {info['substep_phases']} phases a substep and "
              f"{info['reward_phases']} for the reward, "
              f"{info['shared_bytes_a_group']} B of shared memory a group; "
              f"ptxas: {' | '.join(info['ptxas'])}; the lane layout's: "
              f"{' | '.join(info['lane_ptxas'])}", flush=True)

    # ---- 36. the split layout: bits against the lane kernel and plain ----
    mark_phase("36")
    split_check, split_err = {}, {}
    for name in SPLIT:
        split_check[name], split_err[name] = check_split(
            name, ENVS[name](), dev, CHECKED[name])
        print(f"check {name} split layout: N={N_CHECK} H="
              f"{CHECKED[name]['acts'].shape[1]} "
              f"{json.dumps(split_check[name])}; max abs err against plain: "
              f"split {split_err[name]['split']:.3g}, lane "
              f"{split_err[name]['lane']:.3g}", flush=True)

    # ---- 37. timings, and the episodes once more through the other layout
    mark_phase("37")
    split_times, other_runs = {}, {}
    routed_runs = {"door-v0": {"return": out["episode_return"],
                               "success": out["episode_success"],
                               "wall_s": out["episode_wall_s"],
                               "launches": out["episode_launches"]},
                   **{name: episodes[name]
                      for name in SPLIT if name in VARIANT_B},
                   **{name: scene_episodes[name][0]
                      for name in SPLIT if name in SCENES},
                   **{name: rest_episodes[name][0]
                      for name in SPLIT if name in REST}}
    # the phase that ran each env's seed-0 episode through its routed layout
    routed_phase = {name: 20 if name in SCENES else 24 if name in REST
                    else 12 for name in SPLIT}
    routed_phase["door-v0"] = 4
    for name, cfg in SPLIT.items():
        env = ENVS[name]()
        split_times[name] = time_split(name, env, dev)
        split_info[name]["blocks_per_sm"] = split_occupancy(
            split_builds[name].result()[0])
        print(f"timings {name} (lane, split, split, lane; real step and PPI "
              f"iteration in both layouts): {json.dumps(split_times[name])}; "
              f"split blocks an SM: {split_info[name]['blocks_per_sm']}",
              flush=True)
        check(rk.kernel_layout(env) == cfg["routed"], f"{name}: not routed "
              f"to the {cfg['routed']} layout")
        other = "lane" if cfg["routed"] == "split" else "split"
        args_list = cfg["episode"] or DOOR_ARGS + ["--timesteps", "250"]
        with layout_of(type(env), other):
            ret, success, wall, got = run_episode(
                args_list, cfg["shape"][0], 0, key=rk.LAUNCH_KEYS[other])
        other_runs[name] = {"layout": other, "return": ret,
                            "success": success, "wall_s": wall,
                            "launches": got}
        routed = routed_runs[name]
        print(f"episode {name} seed 0, {other} layout: "
              f"{json.dumps(other_runs[name])}; {cfg['routed']} layout "
              f"(phase {routed_phase[name]}): return "
              f"{routed['return']!r}, wall {routed['wall_s']:.1f} s",
              flush=True)
        check(got == routed["launches"] == cfg["launches"],
              f"{name}: {got} and {routed['launches']} launches, expected "
              f"{cfg['launches']}")
        check(ret == routed["return"] and success == routed["success"],
              f"{name}: {other} layout's return {ret!r} ({success}), the "
              f"{cfg['routed']} layout's {routed['return']!r} "
              f"({routed['success']})")
    # ---- 38. the ball-in-a-cup kernel's build ---------------------------
    mark_phase("38")
    from ppi_tpu_torch.studies.bic_layout import sass_counts
    bic_info = {}
    for lay, build in bic_builds.items():
        bic_lib, bic_s = build.result()
        info = {"lines": len(bic_headers[lay].splitlines()), "nvcc_s": bic_s,
                "ptxas": ptxas_summary(bic_lib), "sass": sass_counts(bic_lib),
                "ops_per_lane_step": bk.ops_per_lane_step(BallInCupSim())}
        info.update(regs_spills(info["ptxas"]))
        bic_info[lay] = info
        print(f"body build ball-in-a-cup, {lay} layout "
              f"({bk.SOURCES[lay][0]}): {info['lines']} generated lines, "
              f"{info['ops_per_lane_step']} f32 ops a lane step, nvcc "
              f"{bic_s:.1f} s (in parallel with phase 1); ptxas: "
              f"{' | '.join(info['ptxas'])}; SASS {json.dumps(info['sass'])}",
              flush=True)
    print(f"ball-in-a-cup route: {bk.route(BallInCupSim())} layout",
          flush=True)

    # ---- 39. the ball-in-a-cup kernel vs plain ------------------------------
    mark_phase("39")
    bic_check = check_bic(dev)
    print(f"check ball-in-a-cup, {bic_check['layout']} layout: "
          f"N={BIC_N_CHECK}, {BIC_PHASES} stabilize/trajectory/cool-down "
          f"steps: bit for bit the {bic_check['other_layout']} layout, NaN "
          f"lane and all; errors {json.dumps(bic_check['errors'])} (tol "
          f"{BIC_TOL}, statistics {BIC_STATS_TOL}, reaction "
          f"{BIC_REACTION_ATOL} N), reward max abs "
          f"{bic_check['max_abs_err']:.3g}; success flags equal "
          f"({bic_check['successes']} successes, {bic_check['violated']} "
          f"violated); NaN lanes {bic_check['nan_lanes']}; sentinels past "
          f"N kept (padded launch at {BIC_PAD_BLOCK[bic_check['layout']]} "
          f"a block); kernel {bic_check['kernel_ms']:.3f} ms, plain "
          f"{bic_check['plain_ms']:.1f} ms", flush=True)
    bic_branches = check_bic_branches(dev)
    print(f"check ball-in-a-cup branches, {bic_branches['layout']} layout: "
          f"N={BIC_BRANCH_N}, {BIC_BRANCH_PHASES} steps, the elbow raised: "
          f"{bic_branches['successes']} successes and "
          f"{bic_branches['violated']} violated, flags equal, bit for bit "
          f"the other layout; errors "
          f"{json.dumps(bic_branches['errors'])} (the check's "
          f"tolerances); plain on the CPU "
          f"{bic_branches['plain_cpu_ms']:.1f} ms", flush=True)

    # ---- 40. the ball-in-a-cup kernel's time --------------------------------
    mark_phase("40")
    bic_time = time_bic(dev)
    print(f"timings ball-in-a-cup (both layouts in turns, the {bic_time['layout']} "
          f"layout routed): {json.dumps(bic_time)}", flush=True)

    # ---- 41. make policy-search ---------------------------------------------
    mark_phase("41")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        search_out = policy_search_phase(Path(tmp))
    search_out["layouts"] = search_layouts()

    # ---- 42. the classic envs -----------------------------------------------
    mark_phase("42")
    classic_out = classic_phase()
    out.update(bic_build=bic_info, bic_check=bic_check,
               bic_branches=bic_branches, bic_timings=bic_time,
               policy_search=search_out, classic_episodes=classic_out)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 43. resume phase 4's episode from a checkpoint ---------------
        mark_phase("43")
        resume_out = resume_phase(track, final4["state"], Path(tmp) / "ckpt")
        # ---- 47. collect_expert (before 44, which reads its npz) ---------
        mark_phase("47")
        collect_out = collect_phase(Path(tmp) / "expert")
        # ---- 44. prior fitting ---------------------------------------------
        mark_phase("44")
        prior_out = prior_phase(collect_out["npz"], Path(tmp) / "prior")
        # ---- 45. the evaluation runners -----------------------------------
        mark_phase("45")
        runners_out = runner_phase(Path(tmp) / "runners")
        # ---- 46. the scripted experts on the palm-IK kernel --------------
        mark_phase("46")
        expert_out = expert_phase(dev, ik_builds)
        # ---- 48. SAC on humanoid-standup ------------------------------------
        mark_phase("48")
        sac_out = sac_phase(Path(tmp) / "sac", dev)
        # ---- 49. rendering phase 4's episode ---------------------------------
        mark_phase("49")
        render_out = render_phase(door, track, final4["state"],
                                  Path(tmp) / "render")
        # ---- 50. run_opt --plot, the figures and the animations ------------
        mark_phase("50")
        figures_out = figures_phase(Path(tmp) / "figures")
    out.update(resume=resume_out, prior_fit=prior_out,
               evaluation_runners=runners_out, experts=expert_out,
               collect_expert=collect_out, sac_expert=sac_out,
               render=render_out, figures=figures_out)

    mark_phase("end")
    out.update(split_builds=split_info, split_check=split_check,
               split_max_abs_err=split_err, split_timings=split_times,
               split_other_episodes=other_runs, phase_s=phase_s,
               total_s=time.perf_counter() - t_start)
    print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
    for name in ("43", "44", "45", "46", "47", "48", "49", "50"):
        print(f"phase {name} wall: {phase_s[name]:.1f} s", flush=True)
    print(f"total: {out['total_s']:.0f} s, the kernels' builds included",
          flush=True)

    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_smoke.json").write_text(json.dumps(out, indent=1))
    # door-v0's split layout ran on three paths: phase 4's Lbps episode,
    # make mpc-cem's episode in phase 12 and phase 20's short episodes;
    # its lane layout phase 37's episode
    # and phases 43-45's runs of run_mpc and the evaluation runners
    door_launches = {"split": launches + episodes["door-v0 cem"]["launches"]
                     + sum(r["launches"] for r in short.values())
                     + resume_out["launches_before"]
                     + resume_out["launches_after"]
                     + resume_out["trim_launches"]
                     + sum(prior_out[k]["launches"] for k in prior_out)
                     + sum(runners_out[k]["launches"]
                           for k in ("multi_start", "profile_mpc",
                                     "corl_curves")),
                     "lane": other_runs["door-v0"]["launches"]}
    # pen-v0's routed layout: phase 12's episode and phase 45's goal sweep
    episodes[GOAL_ENV]["launches"] += runners_out["goal_success"]["launches"]
    kernels = [
        {"name": "door_rollout", "route": "cuda",
         "source": "ppi_tpu_torch/csrc/rollout.cu",
         "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
         "launches": door_launches["lane"],
         "max_abs_err": max_abs, "ms": timings["kernel_ms_N1024_H160"],
         "plain_ms": timings["plain_ms_N1024_H20"],
         "bound_ms": timings["bound_ms_N1024_H160"],
         "bound_by": "operations", "library_ms": None,
         **regs_spills(split_info["door-v0"]["lane_ptxas"]),
         **shapes((1024, 160), (1024, 20), timings["kernel_ms_N1024_H20"])},
        {"name": "door_split_rollout", "route": "cuda",
         "source": "ppi_tpu_torch/csrc/rollout_split.cu",
         "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
         "launches": door_launches["split"],
         "max_abs_err": split_err["door-v0"]["split"],
         "ms": turns_mean(split_times["door-v0"], (1024, 160), "split"),
         "plain_ms": timings["plain_ms_N1024_H20"],
         "bound_ms": split_times["door-v0"]["bound_ms_N1024_H160"],
         "bound_by": split_times["door-v0"]["bound_by"], "library_ms": None,
         **regs_spills(split_info["door-v0"]["ptxas"]),
         **shapes((1024, 160), (1024, 20), None)},
        {"name": "moment_match", "route": "cuda",
         "source": "ppi_tpu_torch/csrc/moment_match.cu",
         "replaces": "ppi_tpu/ops/pallas_ops.py:78",
         "launches": mm_launches, "max_abs_err": mm_max_abs,
         "ms": mm_times["kernel_ms_4096x640"],
         "plain_ms": mm_times["plain_ms_4096x640"],
         "bound_ms": mm_times["bound_tc_ms_4096x640"],
         "bound_by": mm_bound_tc_by,
         "bound_simt_ms": mm_times["bound_ms_4096x640"],
         "bound_simt_by": mm_bound_by,
         "library_ms": mm_times["library_ms_4096x640"],
         "launch_device_us": mm_times["launch_us_4096x640"],
         **next(v for k, v in ptxas_by_kernel(mm_lib).items()
                if "mm_mainILi128" in k),
         **shapes((4096, 640), (4096, 640), mm_times["kernel_ms_4096x640"])}]

    def split_pair(env_name, stem, t, routed_launches):
        """The lane and split entries of a body with a split body: its
        phase 12's, 20's or 24's episodes through the routed layout
        (``routed_launches``), phase 37's through the other; times from
        phase 37's turns (``ms`` the main path's call, ``kernel_alone_ms``
        the kernel alone), the plain rollout and bound from ``t`` (phase
        11's, 19's or 23's)."""
        n, h = SPLIT[env_name]["shape"]
        ran = {SPLIT[env_name]["routed"]: routed_launches,
               other_runs[env_name]["layout"]:
                   other_runs[env_name]["launches"]}
        for layout in ("lane", "split"):
            ms = turns_mean(split_times[env_name], (n, h), layout)
            kernels.append(
                {"name": f"{stem}_{'split_' if layout == 'split' else ''}"
                         "rollout",
                 "route": "cuda",
                 "source": f"ppi_tpu_torch/csrc/{SOURCES[layout]}",
                 "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
                 "launches": ran[layout],
                 "max_abs_err": split_err[env_name][layout], "ms": ms,
                 "kernel_alone_ms": turns_mean(split_times[env_name],
                                               (n, h), layout,
                                               "kernel_turns_ms"),
                 "plain_ms": t[f"plain_ms_N{n}_H{H_PLAIN}"],
                 "bound_ms": t[f"bound_ms_N{n}_H{h}"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 **regs_spills(split_info[env_name][
                     "ptxas" if layout == "split" else "lane_ptxas"]),
                 **shapes((n, h), (n, H_PLAIN),
                          t[f"kernel_ms_N{n}_H{H_PLAIN}"]
                          if layout == SPLIT[env_name]["routed"] else None)})

    for env_name, cfg in VARIANT_B.items():
        n, h = cfg["shape"]
        t = b_times[env_name]
        if env_name in SPLIT:
            split_pair(env_name, env_name.split("-")[0], t,
                       episodes[env_name]["launches"])
            continue
        kernels.append(
            {"name": f"{env_name.split('-')[0]}_rollout", "route": "cuda",
             "source": "ppi_tpu_torch/csrc/rollout.cu",
             "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
             "launches": episodes[env_name]["launches"],
             "max_abs_err": b_max_abs[env_name],
             "ms": t[f"kernel_ms_N{n}_H{h}"],
             "plain_ms": t[f"plain_ms_N{n}_H{H_PLAIN}"],
             "bound_ms": t[f"bound_ms_N{n}_H{h}"], "bound_by": t["bound_by"],
             "library_ms": None,
             **shapes((n, h), (n, H_PLAIN),
                      t[f"kernel_ms_N{n}_H{H_PLAIN}"])})
    for env_name, cfg in SCENES.items():
        if env_name in WARP:
            continue
        n, h = cfg["shape"]
        t = scene_times[env_name]
        stem = env_name.replace("-v0", "").replace("-", "_")
        if env_name in SPLIT:
            split_pair(env_name, stem, t, sum(
                r["launches"] for r in scene_episodes[env_name]))
            continue
        kernels.append(
            {"name": f"{stem}_rollout",
             "route": "cuda", "source": "ppi_tpu_torch/csrc/rollout.cu",
             "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
             "launches": sum(r["launches"] for r in scene_episodes[env_name]),
             "max_abs_err": scene_max_abs[env_name],
             "ms": t[f"kernel_ms_N{n}_H{h}"],
             "plain_ms": t[f"plain_ms_N{n}_H{H_PLAIN}"],
             "bound_ms": t[f"bound_ms_N{n}_H{h}"], "bound_by": t["bound_by"],
             "library_ms": None,
             **shapes((n, h), (n, H_PLAIN),
                      t[f"kernel_ms_N{n}_H{H_PLAIN}"])})
    for env_name, cfg in ADROIT.items():
        if env_name in WARP:
            continue
        n, h = cfg["shape"]
        pn, ph = cfg["plain_shape"]
        t = adroit_times[env_name]
        kernels.append(
            {"name": f"{env_name.replace('-v0-', '_')}_rollout",
             "route": "cuda", "source": "ppi_tpu_torch/csrc/rollout.cu",
             "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
             "launches": adroit_episodes[env_name]["launches"],
             "max_abs_err": adroit_max_abs[env_name],
             "ms": t[f"kernel_ms_N{n}_H{h}"],
             "plain_ms": t[f"plain_ms_N{pn}_H{ph}"],
             "bound_ms": t[f"bound_ms_N{n}_H{h}"], "bound_by": t["bound_by"],
             "library_ms": None,
             **shapes((n, h), (pn, ph), t[f"kernel_ms_N{pn}_H{ph}"])})
    for env_name, cfg in REST.items():
        if env_name in WARP:
            continue
        n, h = cfg["shape"]
        t = rest_times[env_name]
        stem = env_name.replace("~", "_").replace("-", "_")
        if env_name in SPLIT:
            split_pair(env_name, stem, t, sum(
                r["launches"] for r in rest_episodes[env_name]))
            continue
        kernels.append(
            {"name": f"{stem}_rollout",
             "route": "cuda", "source": "ppi_tpu_torch/csrc/rollout.cu",
             "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
             "launches": sum(r["launches"] for r in rest_episodes[env_name]),
             "max_abs_err": rest_max_abs[env_name],
             "ms": t[f"kernel_ms_N{n}_H{h}"],
             "plain_ms": t[f"plain_ms_N{n}_H{H_PLAIN}"],
             "bound_ms": t[f"bound_ms_N{n}_H{h}"], "bound_by": t["bound_by"],
             "library_ms": None,
             **shapes((n, h), (n, H_PLAIN),
                      t[f"kernel_ms_N{n}_H{H_PLAIN}"])})
    # the eight warp-layout bodies: the lane layout's entry (phase 34's
    # episodes, block 128) beside the warp layout's (phases 16, 20, 24 and
    # 28)
    for env_name, cfg in WARP.items():
        n, h = cfg["shape"]
        t = warp_times[env_name]
        if env_name in HAND:
            pn, ph = 64, HAND[env_name]["h_plain"]
            routed = hand_times[env_name]
            warp_launches = sum(r["launches"]
                                for r in hand_episodes[env_name])
        elif env_name in SCENES or env_name in REST:
            pn, ph = n, H_PLAIN
            routed = (scene_times if env_name in SCENES
                      else rest_times)[env_name]
            warp_launches = sum(r["launches"] for r in (
                scene_episodes if env_name in SCENES
                else rest_episodes)[env_name])
        else:
            pn, ph = ADROIT[env_name]["plain_shape"]
            routed = adroit_times[env_name]
            warp_launches = adroit_episodes[env_name]["launches"]
        plain_ms = routed[f"plain_ms_N{pn}_H{ph}"]
        # phases 15, 19, 23 and 27 time the kernel as routed (the warp
        # layout) at the plain rollout's shape; phase 34 times the lane
        # layout only at the canonical shape, the plain rollout's for phase
        # 19's and 23's bodies
        at_plain = {"lane": t[f"lane_128_ms_N{n}_H{h}"]
                    if (pn, ph) == (n, h) else None,
                    "warp": routed[f"kernel_ms_N{pn}_H{ph}"]}
        stem = env_name.replace("-v0-", "_").replace("-", "_")
        for layout, source, launches, ms in (
                ("lane", "rollout.cu", lane_episodes[env_name]["launches"],
                 t[f"lane_128_ms_N{n}_H{h}"]),
                ("warp", "rollout_warp.cu", warp_launches,
                 t[f"warp_ms_N{n}_H{h}"])):
            kernels.append(
                {"name": f"{stem}_rollout" if layout == "lane"
                         else f"{stem}_warp_rollout",
                 "route": "cuda", "source": f"ppi_tpu_torch/csrc/{source}",
                 "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
                 "launches": launches,
                 "max_abs_err": warp_err[env_name][layout], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": t[f"bound_ms_N{n}_H{h}"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 **shapes((n, h), (pn, ph), at_plain[layout])})
    kernels.append(mesh_kernel)
    # the layout whose counter the main path's run moved
    routed = search_out["layout"]
    kernels.append(
        {"name": "bic_rollout", "route": "cuda", "layout": routed,
         "source": f"ppi_tpu_torch/csrc/{bk.SOURCES[routed][0]}",
         "replaces": "ppi_tpu/envs/episodic.py BallInACup.evaluate: "
                     "jax.vmap of BallInCupSim.execute_trajectory "
                     "(ppi_tpu/envs/ball_in_a_cup.py:341), an XLA scan; "
                     "no Pallas kernel",
         "launches": search_out["launches"],
         "max_abs_err": bic_check["max_abs_err"],
         "ms": bic_time[f"{routed}_ms_N{BIC_N_TIME}_steps{bic_time['steps']}"],
         "plain_ms": bic_check["plain_ms"],
         "bound_ms": bic_time["bound_ms"], "bound_by": bic_time["bound_by"],
         "library_ms": None,
         **{k: bic_info[routed][k] for k in ("registers",
                                             "spill_stores_bytes",
                                             "spill_loads_bytes")},
         **shapes((BIC_N_TIME, bic_time["steps"]),
                  (BIC_N_CHECK, sum(BIC_PHASES)), bic_check["kernel_ms"])})
    # the palm-IK kernel's five bodies: the launches of their experts'
    # main-path runs, the time at the expert's first call's count
    ik_replaces = {
        "door-v0-hand": "ppi_tpu/envs/door_hand.py:344-361",
        "door-v0-adroit": "ppi_tpu/envs/door_adroit.py:351-371",
        "hammer-v0-hand": "ppi_tpu/envs/hammer_hand.py:367-386",
        "hammer-v0-adroit": "ppi_tpu/envs/hammer_adroit.py:390-409",
        "relocate-v0-adroit": "ppi_tpu/envs/relocate_adroit.py:360-379"}
    for name, cfg in IK_BODIES.items():
        t = expert_out["ik"][name]
        iters = cfg["iters"][0]
        kernels.append(
            {"name": f"ik_palm_{name.replace('-v0-', '_')}", "route": "cuda",
             "source": "ppi_tpu_torch/csrc/ik_palm.cu",
             "replaces": f"{ik_replaces[name]}: the palm IK's jax.grad "
                         "loop; no Pallas kernel",
             "launches": sum(e["ik_launches"]
                             for k, e in expert_out["experts"].items()
                             if k.split(" ")[0] == name),
             "max_abs_err": t["max_abs_err"],
             "ms": t[f"kernel_ms_iters{iters}"], "iters": iters,
             "plain_ms": t[f"plain_ms_iters{IK_PLAIN_ITERS}"],
             "plain_iters": IK_PLAIN_ITERS,
             "kernel_ms_at_plain_iters": t[f"kernel_ms_iters{IK_PLAIN_ITERS}"],
             "bound_ms": t[f"bound_ms_iters{iters}"],
             "bound_by": "operations",
             "chain_bound_ms": t[f"chain_ms_iters{iters}"],
             "library_ms": None,
             **regs_spills(expert_out["builds"][name]["ptxas"])})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
