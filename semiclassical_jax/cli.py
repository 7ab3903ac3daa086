# coding: utf-8
"""`semi` — the command-line task runner.

Same user contract as the reference CLI (reference cli.py:51-166): JSON input
documents of the form {"semi": [task, ...]} and the subcommands

    semi dynamics input.json     run semiclassical dynamics
    semi rates input.json        Fourier-transform correlations into k_IC(E)
    semi spectrum input.json     Fourier-transform C(t) into the FC spectrum
    semi plot correlations.npz   plot correlation/rate curves
    semi export correlations.npz export .dat tables
    semi show correlations.npz   print summary

with the same task keywords and the same `.npz` accumulation semantics.
Differences from the reference: `--cuda` is replaced by mesh controls (all
local devices are used by default, sharding the trajectory ensemble), the time
loop runs as one jitted scan per repetition (not per step), and random keys
derive from an explicit `jax.random` tree.
"""

from __future__ import annotations

import argparse
import json
import logging
import os.path
import sys

import numpy as np

logging.basicConfig(format="[%(module)-12s] %(message)s", level=logging.INFO)
logger = logging.getLogger(__name__)


class ConfigurationError(Exception):
    pass


def main(argv=None):
    import semiclassical_jax

    parser = argparse.ArgumentParser(prog="semi")
    parser.add_argument(
        "--version", action="version",
        version=f"%(prog)s {semiclassical_jax.__version__} "
                f"[Python {'.'.join(map(str, sys.version_info[:3]))}]",
    )

    subparsers = parser.add_subparsers(help="commands", dest="command")

    parser_dynamics = subparsers.add_parser(
        "dynamics", help="run semiclassical dynamics")
    parser_dynamics.add_argument("json_input", type=str, metavar="input.json")
    parser_dynamics.add_argument(
        "--devices", type=int, default=0, metavar="n",
        help="number of devices for the trajectory mesh "
             "(default 0 = all available)")
    parser_dynamics.add_argument(
        "--precision", choices=["f64", "mixed", "comp32", "f32"],
        default=None,
        help="numerical mode: f64 (full double, the CPU default), mixed "
             "(f64 trajectories + f32 monodromy/complex algebra, the "
             "accelerator default), comp32 (compensated-f32 trajectories: "
             "near-mixed accuracy at native-f32 speed; the accelerator "
             "default for the anharmonic AS model), f32 (fastest, reduced "
             "accuracy)")
    # Multi-host scale-out (SURVEY §2.2 P2/P5): each process runs
    # independent ensemble batches and merges them through the locked
    # npz accumulation protocol (`results.overwrite: false`) on the
    # shared filesystem; random streams differ per process by key
    # folding. `--coordinator` additionally initialises jax.distributed
    # for multi-process runs (one process per GPU, each pinned to its card
    # with CUDA_VISIBLE_DEVICES). Equivalent envs: SEMI_COORDINATOR,
    # SEMI_NUM_PROCESSES, SEMI_PROCESS_ID.
    parser_dynamics.add_argument(
        "--coordinator", type=str,
        default=os.environ.get("SEMI_COORDINATOR", ""),
        metavar="host:port",
        help="jax.distributed coordinator address for multi-host runs "
             "(process 0's host); requires --num-processes/--process-id "
             "or their SEMI_* envs")
    parser_dynamics.add_argument(
        "--num-processes", type=int,
        default=int(os.environ.get("SEMI_NUM_PROCESSES", "0")),
        help="total number of cooperating processes (with --coordinator)")
    parser_dynamics.add_argument(
        "--process-id", type=int,
        default=int(os.environ.get("SEMI_PROCESS_ID", "-1")),
        help="rank of this process (with --coordinator; also folded into "
             "the sampling key so per-process ensembles are independent)")

    parser_rates = subparsers.add_parser(
        "rates",
        help="compute Fermi's-Golden-Rule rates by Fourier transforming "
             "correlation functions")
    parser_rates.add_argument("json_input", type=str, metavar="input.json")

    parser_spectrum = subparsers.add_parser(
        "spectrum",
        help="compute the (Franck-Condon) absorption spectrum by Fourier "
             "transforming the wavepacket autocorrelation")
    parser_spectrum.add_argument("json_input", type=str,
                                 metavar="input.json")

    parser_plot = subparsers.add_parser(
        "plot", help="plot correlation and rate functions from .npz files")
    parser_plot.add_argument("correlation_files", type=str, nargs="+",
                             metavar="correlations.npz")
    parser_plot.add_argument(
        "--save", type=str, default="", metavar="figure.png",
        help="write the figure to this file instead of opening a window "
             "(for machines without a display; any matplotlib-supported "
             "extension works: .png, .pdf, .svg)")

    parser_export = subparsers.add_parser(
        "export",
        help="export correlation functions and rates from .npz to .dat "
             "tables (autocorrelation.dat, ic_correlation.dat, ic_rate.dat)")
    parser_export.add_argument("correlation_file", type=str,
                               metavar="correlations.npz")

    parser_show = subparsers.add_parser(
        "show", help="show information about a .npz results file")
    parser_show.add_argument("correlation_file", type=str,
                             metavar="correlations.npz")

    args = parser.parse_args(argv)

    if args.command == "dynamics":
        if args.coordinator:
            # multi-process run: must run before the backend is touched
            import jax as _jaxd
            assert args.num_processes > 0 and args.process_id >= 0, (
                "--coordinator requires --num-processes and --process-id "
                "(or SEMI_NUM_PROCESSES / SEMI_PROCESS_ID)")
            _jaxd.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id)
            logger.info(f"jax.distributed initialised: process "
                        f"{args.process_id}/{args.num_processes} via "
                        f"{args.coordinator}")
        # persistent XLA compile cache: every invocation otherwise
        # recompiles the sampling and scan programs
        from semiclassical_jax.hostcache import use_compile_cache
        try:
            use_compile_cache()
        except OSError as exc:
            # read-only checkout etc. — degrade to uncached compiles
            # rather than refusing to run
            logger.warning(f"compile cache disabled ({exc})")

    try:
        if args.command == "dynamics":
            with open(args.json_input) as f:
                config = json.load(f)
            logger.info(f"run all 'dynamics' tasks in {args.json_input}")
            from semiclassical_jax.config import validate_task
            for task in config["semi"]:
                validate_task(task)
            for task in config["semi"]:
                if task["task"] == "dynamics":
                    run_semiclassical_dynamics(
                        task, num_devices=args.devices,
                        precision=getattr(args, "precision", None))
        elif args.command == "rates":
            assert args.json_input.endswith(".json"), (
                "The argument for the command 'rates' should be the JSON "
                f"control file, got '{args.json_input}' instead.")
            with open(args.json_input) as f:
                config = json.load(f)
            logger.info(f"run all 'rates' tasks in {args.json_input}")
            from semiclassical_jax.config import validate_task
            for task in config["semi"]:
                validate_task(task)
            for task in config["semi"]:
                if task["task"] == "rates":
                    calculate_rates(task)
        elif args.command == "spectrum":
            with open(args.json_input) as f:
                config = json.load(f)
            logger.info(f"run all 'spectrum' tasks in {args.json_input}")
            from semiclassical_jax.config import validate_task
            for task in config["semi"]:
                validate_task(task)
            for task in config["semi"]:
                if task["task"] == "spectrum":
                    calculate_spectrum(task)
        elif args.command == "plot":
            _plot_correlation_functions(args.correlation_files,
                                        save=args.save)
        elif args.command == "export":
            _export_tables(args.correlation_file)
        elif args.command == "show":
            _show_information(args.correlation_file)
        else:
            parser.print_help()
    except Exception:
        logger.exception(
            """
        An error occurred, see traceback below

        Suggestions:
         * Check the JSON input file for mistakes.
         * If there is insufficient memory, decrease 'batch_size'.
         * If energy conservation is violated, check that the potential has
           a stable minimum or reduce the step size.
        """
        )
        return 1
    return 0


def _build_potential(task):
    """Construct (potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap,
    atomic_numbers) from the task's `potential` section
    (reference cli.py:177-304)."""
    import jax.numpy as jnp

    from semiclassical_jax import potentials, units
    from semiclassical_jax.io import FormattedCheckpointFile

    p = task["potential"]
    atomic_numbers = None

    if p["type"] == "harmonic":
        with open(p["ground"]) as f:
            freq_fchk = FormattedCheckpointFile(f)
        with open(p["coupling"]) as f:
            nacs_fchk = FormattedCheckpointFile(f)
        potential = potentials.MolecularHarmonicPotential.from_fchk(
            freq_fchk, nacs_fchk)
        with open(p["excited"]) as f:
            excited_fchk = FormattedCheckpointFile(f)
        x0, Gamma_0, en_zpt = excited_fchk.vibrational_groundstate()
        q0 = np.asarray(x0)
        p0 = np.zeros_like(q0)
        atomic_numbers = excited_fchk["Atomic numbers"]

    elif p["type"] == "gdml":
        model_pot = np.load(p["ground"], allow_pickle=True)
        with open(p["coupling"]) as f:
            nacs_fchk = FormattedCheckpointFile(f)
        potential = potentials.MolecularGDMLPotential.create(
            model_pot, nacs_fchk,
            hess_dtype=p.get("hess_dtype") or None,
            hessian_eval=p.get("hessian_eval", "stage"),
            taylor_every=p.get("taylor_every", 1))
        logger.info("  hessian_eval                              : "
                    f"{potential.hessian_eval}"
                    + (f" (re-expansion every {potential.taylor_every} steps)"
                       if potential.taylor_every > 1 else ""))
        with open(p["excited"]) as f:
            excited_fchk = FormattedCheckpointFile(f)
        x0, Gamma_0, en_zpt = excited_fchk.vibrational_groundstate()
        q0 = np.asarray(x0)
        p0 = np.zeros_like(q0)
        atomic_numbers = excited_fchk["Atomic numbers"]

    elif p["type"] == "anharmonic AS":
        data = np.loadtxt(p["model_file"])
        if data.ndim == 1:
            data = data.reshape(1, -1)
        logger.info("vibrational modes (cm^-1):")
        logger.info(f"{data[:, 0]}")
        omega = data[:, 0] / units.hartree_to_wavenumbers
        S = data[:, 1]
        nac = data[:, 2]
        chi = data[:, 3]
        # horizontal shift dQ from the Huang-Rhys factor S = dQ^2 omega / 2
        dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
        dQ[omega == 0.0] = 0.0
        potential = potentials.MorsePotential.create(
            omega, chi, nac,
            hessian_eval=p.get("hessian_eval", "stage"),
            taylor_every=p.get("taylor_every", 1))
        if potential.hessian_eval != "stage":
            logger.info("  hessian_eval                              : "
                        f"{potential.hessian_eval}"
                        + (f" (re-expansion every {potential.taylor_every}"
                           " steps)" if potential.taylor_every > 1 else ""))
        Gamma_0 = np.diag(omega)
        q0 = dQ
        p0 = 0.0 * q0
        en_zpt = float(np.sum(0.5 * omega))
        excited_fchk = None
    else:
        raise ConfigurationError(
            f"Unknown potential type in {task['potential']}")

    # find the minimum of the final PES; energies are measured from there
    if hasattr(potential, "origin"):
        logger.info("find minimum on final potential energy surface")
        potential = potentials.minimize(potential, jnp.asarray(q0))

    if p["type"] in ("harmonic", "gdml"):
        adiabatic_gap = float(excited_fchk.total_energy()
                              - potential.total_energy())
        logger.info(
            "  adiabatic excitation energy               : "
            f"{adiabatic_gap * units.hartree_to_ev:.4f} eV")
    else:
        adiabatic_gap = np.nan

    return potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap, atomic_numbers


def _multiprocess_rank(jax):
    """(is_multiprocess, rank) of this process in a cooperating
    accumulation run.

    Two ways to cooperate: a jax.distributed run (``--coordinator``,
    rank = jax.process_index()), or the coordinator-less
    shared-filesystem mode where independent processes simply share the
    results npz (rank = SEMI_PROCESS_ID). Either way each rank contributes
    independent ensemble batches through the locked accumulate protocol
    (io/results.py) — the concurrent equivalent of the reference's
    sequential cross-invocation accumulation (reference cli.py:344-364,
    README.rst:111-115).
    """
    try:
        if jax.process_count() > 1:
            return True, int(jax.process_index())
    except Exception:
        pass
    env = os.environ.get("SEMI_PROCESS_ID")
    if env is not None:
        return True, int(env)
    return False, 0


def run_semiclassical_dynamics(task, num_devices=0, precision=None):
    """Run one `dynamics` task (reference cli.py:171-476).

    precision: "f64" | "mixed" | "f32" | None (None = f64 on CPU, mixed on
    accelerators).
    """
    import jax
    import jax.numpy as jnp

    from semiclassical_jax import units
    from semiclassical_jax.io.extxyz import write_extxyz
    from semiclassical_jax.io.results import accumulate_results, init_results
    from semiclassical_jax.parallel import ensemble_mesh
    from semiclassical_jax.propagation import (
        HermanKlukPropagator,
        WaltonManolopoulosPropagator,
    )

    (potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap,
     atomic_numbers) = _build_potential(task)

    Gamma_i = Gamma_0
    Gamma_t = Gamma_0

    dt = task["time_step_fs"] / units.autime_to_fs
    nt = task["num_steps"]
    t_max = nt * dt
    times = np.linspace(0.0, t_max, nt)

    logger.info(f"  time step                                 : "
                f"{dt * units.autime_to_fs:.5f} fs")
    logger.info(f"  number of time steps                      : {nt}")
    logger.info(f"  propagation time                          : "
                f"{t_max * units.autime_to_fs:.5f} fs")

    batch_size = task.get("batch_size", 10000)
    num_trajectories = task.get("num_trajectories", 50000)
    num_repetitions = max(num_trajectories // batch_size, 1)
    num_samples = min(batch_size, num_trajectories)

    logger.info(f"  number of repetitions                     : "
                f"{num_repetitions}")
    logger.info(f"  number of trajectories per repetition     : "
                f"{num_samples}")
    logger.info(f"  total number of trajectories              : "
                f"{num_samples * num_repetitions}")

    propagator_name = task.get("propagator", "HK")
    logger.info(f"  propagator                                : "
                f"{propagator_name}")
    # "exact" selects the closed-form Morse propagation map (zero
    # time-discretization error; separable Morse PES with bound orbits
    # only — propagation/exact_morse.py); "rk4" matches the reference
    # trajectory-for-trajectory.
    integrator = task.get("integrator", "rk4")
    if integrator not in ("rk4", "exact"):
        raise ValueError(f"unknown integrator {integrator!r} "
                         "(expected 'rk4' or 'exact')")
    logger.info(f"  integrator                                : {integrator}")

    devices = jax.devices()
    if num_devices > 0:
        devices = devices[:num_devices]
    logger.info(f"  devices                                   : "
                f"{len(devices)} x {devices[0].device_kind} "
                f"({devices[0].platform})")
    mesh = ensemble_mesh(devices) if len(devices) > 1 else None
    if mesh is not None:
        logger.info(f"  trajectory mesh                           : "
                    f"{len(devices)} devices")

    filename = task["results"].get("correlations", "correlations.npz")
    overwrite = task["results"].get("overwrite", True)
    # multi-process accumulation mode (SURVEY §2.2 P2): cooperating ranks
    # merge independent batches into the same npz through the file lock;
    # the rank is folded into the sampling key below, so a shared
    # manual_seed still yields disjoint random streams per process
    multiproc, rank = _multiprocess_rank(jax)
    if multiproc and overwrite:
        # a rank that resets the shared accumulator mid-run would silently
        # drop every other rank's batches — accumulate instead (delete the
        # stale file before launching the ranks)
        logger.warning("multi-process run: results.overwrite forced to "
                       "false (delete the old npz before launching)")
        overwrite = False
    if not overwrite and os.path.exists(filename) and not multiproc:
        assert task.get("manual_seed", None) is None, (
            "Multiple runs with the same sequence of random numbers make no "
            "sense! Do not use `manual_seed` and `overwrite=False` at the "
            "same time")

    # mid-batch checkpoint/resume (finer-grained than the reference's
    # per-repetition npz accumulation, reference cli.py:453-476): with
    # `checkpoint` set, each repetition snapshots its scan carry every
    # `checkpoint_every` steps; a killed run loses at most one segment
    ckpt_file = task.get("checkpoint", "")
    ckpt_every = task.get("checkpoint_every", 500)
    resume_rep = None
    resume_steps_done = 0
    if ckpt_file and os.path.exists(ckpt_file):
        from semiclassical_jax.checkpoint import peek_checkpoint
        meta = peek_checkpoint(ckpt_file)
        resume_rep = int(meta.get("repetition", 0))
        resume_steps_done = int(meta.get("steps_done", 0))
        logger.info(f"found checkpoint '{ckpt_file}' at repetition "
                    f"{resume_rep + 1}, step {resume_steps_done} — "
                    "resuming (completed repetitions are already in "
                    f"'{filename}')")

    init_results(filename, propagator_name, times, adiabatic_gap, en_zpt,
                 overwrite=overwrite and resume_rep is None)

    seed = task.get("manual_seed", None)
    if seed is not None:
        logger.warning("The random number generator should not be seeded "
                       "manually unless for debugging!")
        root_key = jax.random.key(seed)
    else:
        root_key = jax.random.key(
            int(np.random.SeedSequence().entropy % (2**63)))
    if multiproc:
        # disjoint per-rank streams even under a shared manual_seed
        root_key = jax.random.fold_in(root_key, rank)
        logger.info(f"multi-process accumulation: rank {rank} "
                    f"(sampling key folded)")
    rep_keys = jax.random.split(root_key, num_repetitions)

    if precision is None:
        if jax.default_backend() == "cpu":
            precision = "f64"
        elif task["potential"]["type"] == "anharmonic AS":
            # separable model potentials: compensated-f32 trajectories
            # track the mixed mode to 5e-7 over 2000 steps (HK) / 2.5e-7
            # over 500 steps at 60 modes (WM) (tests/test_comp32.py)
            precision = "comp32"
        else:
            precision = "mixed"
    if (task["potential"]["type"] == "gdml"
            and precision in ("comp32", "f32")):
        # sGDML KRR is cancellation-bound (the permutation-expanded alphas
        # reach ~1e11): its energies/gradients require the f64 path, and
        # reduced-precision TRAJECTORIES feeding the descriptors are an
        # unvalidated configuration (the safe reduced-precision knob is the
        # potential's hess_dtype keyword)
        logger.warning(
            f"--precision {precision} with a gdml potential is "
            "unvalidated: sGDML regression sums are cancellation-bound "
            "and were measured to need f64 energies/gradients — use "
            "'mixed' (default) and the potential's hess_dtype keyword "
            "for the validated reduced-precision mode")
    logger.info(f"  numerical precision                       : {precision}")
    if precision == "mixed":
        dtype, traj_dtype = jnp.float32, jnp.float64
    elif precision == "comp32":
        # compensated-f32 trajectories: f64-quality accumulation at
        # native-f32 speed — see propagation/state.py
        dtype, traj_dtype = jnp.float32, "comp32"
    elif precision == "f32":
        dtype, traj_dtype = jnp.float32, jnp.float32
    else:
        dtype, traj_dtype = jnp.float64, jnp.float64
    # model potentials evaluate the PES at their parameter dtype: in the
    # reduced-precision modes cast them to the algebra dtype so the
    # per-stage transcendentals run in f32 (~1e-7 relative PES noise, far
    # below the mixed-mode 1e-4 gate — tests/test_precision.py);
    # GDML potentials manage their own precision (hess_dtype)
    from semiclassical_jax.potentials import (MolecularHarmonicPotential,
                                              MorsePotential,
                                              NonHarmonicPotential)
    from semiclassical_jax.pytree import replace as _pt_replace
    if isinstance(potential, (MorsePotential, NonHarmonicPotential)):
        potential = jax.tree.map(lambda x: x.astype(dtype), potential)
    elif (isinstance(potential, MolecularHarmonicPotential)
          and jnp.dtype(dtype) == jnp.float32):
        # harmonic molecular PES: displacements keep the trajectory
        # precision, the (n, d) @ (d, d) contractions run at f32
        potential = _pt_replace(potential, contract_dtype="float32")

    calc_norm_every = task.get("calc_norm_every", 0)
    # per-step Monte-Carlo standard errors (two extra fused reductions per
    # step in the scan; npz keys autocorrelation_stderr/ic_correlation_stderr)
    error_bars = bool(task.get("error_bars", False))
    # variance-reduced initial-condition sampling (BEYOND-reference;
    # sampling._standard_normals). Measured on the 5-mode AS oracle
    # (tests/test_sampling_vr.py): "sobol" (scrambled QMC, best at
    # power-of-two batch sizes) cuts the realization variance ~250x on
    # C(t) and ~30x on k~ic; "antithetic" +-pairs ~9x on C(t) but
    # slightly WORSE on k~ic (its estimator is predominantly even in the
    # displacements) — use sobol unless reproducing pseudo-random runs.
    # Converged values are unchanged (both draw the same Gaussian).
    sampling_method = task.get("sampling", "pseudo")
    if sampling_method != "pseudo":
        logger.info(f"  sampling                                  : "
                    f"{sampling_method}")

    # scan segmentation: each chunk is one XLA execution followed by a
    # host round-trip (progress log, NaN check). Longer chunks amortise the
    # round-trip on the cheap separable and taylor-window paths; the dense
    # per-stage molecular paths keep 100. Functional defaults, not yet
    # measured on the GPU.
    default_chunk = (500 if (task["potential"]["type"] == "anharmonic AS"
                             or getattr(potential, "hessian_eval", "stage")
                             == "taylor")
                     else 100)
    scan_chunk = task.get("scan_chunk", default_chunk)

    # per-phase wall-clock accounting (SURVEY §5: sample/scan/reduce wall +
    # traj-steps/s/chip, machine-produced instead of hand-assembled; the
    # scan phase of the first repetition includes the XLA compile)
    from semiclassical_jax.profiling import PhaseTimer
    ptimer = PhaseTimer()
    work_traj_steps = 0  # traj-steps actually propagated THIS process

    for repetition in range(num_repetitions):
        if resume_rep is not None and repetition < resume_rep:
            continue
        logger.info(f"*** Repetition {repetition + 1} ***")
        if propagator_name == "WM":
            alpha = task.get("cell_width", 10000.0)
            propagator = WaltonManolopoulosPropagator(
                Gamma_i, Gamma_t, alpha, alpha, dtype=dtype,
                traj_dtype=traj_dtype, integrator=integrator)
        else:
            propagator = HermanKlukPropagator(Gamma_i, Gamma_t, dtype=dtype,
                                              traj_dtype=traj_dtype,
                                              integrator=integrator)

        # device-side micro-batching: lax.map over sub-batches bounds the
        # step intermediates of the memory-bound WM chain and the dense
        # taylor-mode GDML step while the whole batch stays ONE dispatch
        # (hk._micro_scan). Opt out / retune via `micro_batch`. The sizes
        # are functional defaults, not yet measured on the GPU.
        micro = task.get("micro_batch", None)
        if (micro is None and propagator_name == "WM"
                and task["potential"]["type"] == "anharmonic AS"):
            micro = 8192
        elif (micro is None and task["potential"]["type"] == "gdml"
              and getattr(potential, "hessian_eval", "stage") == "taylor"):
            micro = 1024
        if micro:
            propagator.micro_batch = int(micro)
            if repetition == (resume_rep or 0):
                logger.info(f"  device-side micro-batch                   : "
                            f"{int(micro)}")

        with ptimer.phase("sample"):
            propagator.initial_conditions(q0, p0, Gamma_0, ntraj=num_samples,
                                          key=rep_keys[repetition],
                                          potential=potential, mesh=mesh,
                                          sampling_method=sampling_method)

        _export_trajectories(task.get("export_initial", ""), atomic_numbers,
                             propagator, append=(repetition > 0))

        def _progress(done, total, cauto_seg):
            t_fs = times[min(done, nt) - 1] * units.autime_to_fs
            logger.info(f" time/fs= {t_fs:9.4f}  step {done}/{total}  "
                        f"|C(t)|= {np.abs(cauto_seg[-1]):.6f}")

        # norm readout flavour: exact O(n^2), or the subsampled unbiased
        # estimate with its Monte-Carlo error bar (task keyword
        # `norm_samples` — the variance-characterized diagnostic for
        # high-dimensional ensembles where the exact norm is impractical)
        norm_samples = int(task.get("norm_samples", 0))

        def _norm_log(step):
            t_fs = times[step] * units.autime_to_fs
            if norm_samples > 0:
                nrm, err = propagator.norm(sample_pairs=norm_samples,
                                           key=repetition)
                logger.info(f" time/fs= {t_fs:.4f}  "
                            f"norm= {nrm:9.6f} +- {err:.6f}")
            else:
                logger.info(f" time/fs= {t_fs:.4f}  "
                            f"norm= {propagator.norm():9.6f}")

        err_c = err_k = None
        try:
            if ckpt_file:
                from semiclassical_jax.checkpoint import CheckpointedRun

                run = CheckpointedRun(
                    ckpt_file, propagator, potential, dt=dt, nt=nt,
                    energy0_es=en_zpt, segment=ckpt_every,
                    chunk=scan_chunk,
                    repetition=repetition, progress=_progress,
                    error_bars=error_bars,
                    # norm monitoring composes with checkpointing: the
                    # segments split at the monitoring boundaries
                    norm_every=calc_norm_every, norm_callback=_norm_log)
                # err_c/err_k come back None when error_bars is off or the
                # resumed checkpoint predates the request (drop-keys contract)
                with ptimer.phase("scan"):
                    cauto, kic, err_c, err_k = run.run()
            elif calc_norm_every > 0:
                # segmented propagation with norm monitoring in between —
                # the convergence diagnostic of reference cli.py:418-429
                cauto = np.zeros(nt, dtype=complex)
                kic = np.zeros(nt, dtype=complex)
                if error_bars:
                    err_c, err_k = np.zeros(nt), np.zeros(nt)
                done = 0
                while done < nt:
                    seg = min(calc_norm_every, nt - done)
                    _norm_log(done)
                    with ptimer.phase("scan"):
                        out = propagator.propagate(
                            potential, dt, seg, energy0_es=en_zpt,
                            error_bars=error_bars)
                    if error_bars:
                        c_seg, k_seg, e_c, e_k = out
                        err_c[done:done + seg] = e_c
                        err_k[done:done + seg] = e_k
                    else:
                        c_seg, k_seg = out
                    cauto[done:done + seg] = c_seg
                    kic[done:done + seg] = k_seg
                    done += seg
            else:
                with ptimer.phase("scan"):
                    out = propagator.propagate(
                        potential, dt, nt, energy0_es=en_zpt,
                        chunk=scan_chunk, progress=_progress,
                        error_bars=error_bars)
                if error_bars:
                    cauto, kic, err_c, err_k = out
                else:
                    cauto, kic = out

            if np.isnan(cauto).any() or np.isnan(kic).any():
                raise RuntimeError("encountered NaN's in correlations")
        except RuntimeError:
            # NaN watchdog: dump trajectories for debugging
            # (reference cli.py:406-416)
            if atomic_numbers is not None:
                logger.info("NaN's/instability detected, saving trajectories "
                            "to 'current_trajectories.xyz' for debugging ...")
                _export_trajectories("current_trajectories.xyz",
                                     atomic_numbers, propagator, append=False)
            raise

        _export_trajectories(task.get("export_final", ""), atomic_numbers,
                             propagator, append=(repetition > 0))

        # structured per-repetition diagnostics (SURVEY §5 observability)
        from semiclassical_jax.profiling import RunMetrics
        metrics = RunMetrics.from_run(
            getattr(propagator, "last_energies", np.zeros(0)), cauto, kic)
        metrics.log()

        if ckpt_file and os.path.exists(ckpt_file):
            # remove the checkpoint *before* accumulating: a kill between
            # the two loses this batch (the reference's recovery granularity)
            # but can never double-count it on resume
            os.remove(ckpt_file)
        with ptimer.phase("reduce"):
            total = accumulate_results(filename, cauto, kic,
                                       propagator.ntraj,
                                       autocorrelation_stderr=err_c,
                                       ic_correlation_stderr=err_k)
        logger.info(f"  accumulated trajectories: {total}")
        if err_c is not None:
            logger.info(f"  MC stderr: |C(t)| max {err_c.max():.2e}, "
                        f"k~ic max {err_k.max():.2e}")

        # work actually propagated this process: the true (mesh-rounded)
        # trajectory count, minus the steps a resumed checkpoint had
        # already completed before this process started
        steps_run = nt
        if resume_rep is not None and repetition == resume_rep:
            steps_run = max(nt - resume_steps_done, 0)
        work_traj_steps += propagator.ntraj * steps_run

    # machine-produced per-phase wall + throughput (the scan phase of the
    # first repetition includes the one-time XLA compile). Only work that
    # accumulated scan wall IN THIS PROCESS enters the numerator.
    ptimer.log(work_traj_steps, 1,
               nchips=max(1, len(devices)) if mesh is not None else 1)


def _export_trajectories(filename, atomic_numbers, propagator, append=False):
    if filename == "" or atomic_numbers is None:
        return
    from semiclassical_jax.io.extxyz import write_extxyz

    q, p = propagator.current_positions_and_momenta()
    q, p = np.asarray(q), np.asarray(p)
    write_extxyz(filename, atomic_numbers, q, p, append=append)
    logger.info(f"positions and momenta saved to '{filename}'")


def _build_lineshape(task):
    """Resolve the (broadening, hwhmG_ev, hwhmL_ev) task keywords into the
    time-domain lineshape callable. Returns (name, hwhmG, hwhmL, callable)."""
    from semiclassical_jax import units
    from semiclassical_jax.analysis import gaussian, lorentzian, voigtian

    hwhmG = task.get("hwhmG_ev", 0.01)
    hwhmL = task.get("hwhmL_ev", 1.0e-6)
    sigma = hwhmG / np.sqrt(2.0 * np.log(2.0)) / units.hartree_to_ev
    gamma = hwhmL / units.hartree_to_ev

    broad = task.get("broadening", "gaussian")
    if broad == "gaussian":
        lineshape = gaussian(sigma)
    elif broad == "lorentzian":
        lineshape = lorentzian(gamma)
    elif broad == "voigtian":
        lineshape = voigtian(sigma, gamma)
    else:
        raise ValueError("'broadening' should be one of 'gaussian', "
                         "'lorentzian' or 'voigtian'")
    return broad, hwhmG, hwhmL, lineshape


def calculate_rates(task):
    """Run one `rates` task (reference cli.py:519-570)."""
    from semiclassical_jax import units
    from semiclassical_jax.analysis import rate_from_correlation

    broad, hwhmG, hwhmL, lineshape = _build_lineshape(task)

    corr_file = task.get("correlations", "correlations.npz")
    rate_file = task.get("rates", "correlations.npz")

    logger.info(f"compute rates from correlation functions in '{corr_file}'")
    data = dict(np.load(corr_file))
    logger.info(f"trajectories : {data['trajectories']}")
    logger.info(
        f"time grid    : tmin= "
        f"{data['times'].min() * units.autime_to_fs:.4f} tmax= "
        f"{data['times'].max() * units.autime_to_fs:.4f} steps= "
        f"{len(data['times'])}")

    data["broadening"] = broad
    data["hwhmG"] = hwhmG
    data["hwhmL"] = hwhmL

    energies, ic_rate = rate_from_correlation(
        data["times"], data["ic_correlation"], lineshape)

    # 2 pi factor for agreement with FCclasses3 (reference cli.py:560-564)
    ic_rate = ic_rate * 2.0 * np.pi

    data["energies"] = energies[energies >= 0.0]
    data["ic_rate"] = ic_rate[energies >= 0.0].real

    if "ic_correlation_stderr" in data:
        # the transform is linear: the per-step MC stderr of k~ic(t)
        # (error_bars keyword) propagates exactly to one scalar band for
        # the whole rate curve (analysis.fourier_stderr), through the same
        # 2 pi and s^-1 conversions as the rate itself
        from semiclassical_jax.analysis import fourier_stderr
        sigma = fourier_stderr(data["times"], data["ic_correlation_stderr"],
                               lineshape)
        sigma *= 2.0 * np.pi * 1.0e15 / units.autime_to_fs
        data["ic_rate_stderr"] = sigma
        logger.info(f"rate MC stderr (per energy point): {sigma:.3e} s^-1")

    logger.info(f"rates are saved to '{rate_file}'")
    np.savez(rate_file, **data)


def calculate_spectrum(task):
    """Run one `spectrum` task: Fourier-transform the stored wavepacket
    autocorrelation C(t) into the Franck-Condon spectral density S(E)
    (analysis.spectrum_from_correlation). BEYOND-reference capability —
    the reference stores C(t) in every npz but only ever transforms the
    IC correlation (reference rates.py:20-82, cli.py:519-570)."""
    from semiclassical_jax import units
    from semiclassical_jax.analysis import spectrum_from_correlation

    broad, hwhmG, hwhmL, lineshape = _build_lineshape(task)

    corr_file = task.get("correlations", "correlations.npz")
    out_file = task.get("spectra", task.get("spectrum", corr_file))

    logger.info(f"compute the spectrum from the autocorrelation "
                f"in '{corr_file}'")
    data = dict(np.load(corr_file))
    logger.info(f"trajectories : {data['trajectories']}")
    logger.info(
        f"time grid    : tmin= "
        f"{data['times'].min() * units.autime_to_fs:.4f} tmax= "
        f"{data['times'].max() * units.autime_to_fs:.4f} steps= "
        f"{len(data['times'])}")

    energies, spectrum = spectrum_from_correlation(
        data["times"], data["autocorrelation"], lineshape)

    data["spectrum_broadening"] = broad
    data["spectrum_hwhmG"] = hwhmG
    data["spectrum_hwhmL"] = hwhmL
    data["spectrum_energies"] = energies
    data["spectrum"] = spectrum.real

    if "autocorrelation_stderr" in data:
        # linear transform: the per-step MC stderr of C(t) propagates to
        # one scalar band for the whole spectrum (analysis.fourier_stderr)
        from semiclassical_jax.analysis import fourier_stderr
        sigma = fourier_stderr(data["times"], data["autocorrelation_stderr"],
                               lineshape)
        data["spectrum_stderr"] = sigma
        logger.info(f"spectrum MC stderr (per energy point): {sigma:.3e}")

    # with the stored phase convention C(t) = e^{i ZPE t} <phi|e^{-iHt}|phi>
    # the spectrum's peaks sit at E_n - ZPE; report the integral as the
    # normalization diagnostic (= f~(0) C(0) ~ 1 for a converged ensemble)
    total = float(np.trapezoid(spectrum.real, energies))
    logger.info(f"spectrum normalization integral S(E) dE = {total:.6f} "
                f"(~1 for a normalized wavepacket)")
    logger.info(f"the spectrum is saved to '{out_file}'")
    np.savez(out_file, **data)


def _export_tables(filename):
    """Export correlations/rates to .dat tables (reference cli.py:573-627)."""
    from semiclassical_jax import units

    data = np.load(filename)
    trajectories = int(data["trajectories"])
    propagator = str(data["propagator"])

    logger.info(f"exporting correlation functions from '{filename}' to "
                "tables 'autocorrelation.dat' and 'ic_correlation.dat'")
    with open("autocorrelation.dat", "w") as f:
        f.write("# autocorrelation function\n")
        f.write(f"# propagator: {propagator}   trajectories: "
                f"{trajectories}\n")
        f.write(f"# zero-point energy: "
                f"{data['zero_point_energy'] * units.hartree_to_wavenumbers:.2f} cm-1\n")
        f.write("#\n")
        f.write("# Time/fs                  Re[C(t)]                  "
                "Im[C(t)]\n")
        np.savetxt(f, np.vstack((data["times"] * units.autime_to_fs,
                                 data["autocorrelation"].real,
                                 data["autocorrelation"].imag)).T)
    with open("ic_correlation.dat", "w") as f:
        f.write("# IC-correlation function\n")
        f.write(f"# propagator: {propagator}   trajectories: "
                f"{trajectories}\n")
        f.write("#\n")
        f.write("# Time/fs                  Re[kIC(t)]                "
                "Im[kIC(t)]\n")
        np.savetxt(f, np.vstack((data["times"] * units.autime_to_fs,
                                 data["ic_correlation"].real,
                                 data["ic_correlation"].imag)).T)
    if "ic_rate" in data:
        logger.info(f"exporting IC rates from '{filename}' to 'ic_rate.dat'")
        with open("ic_rate.dat", "w") as f:
            f.write("# internal conversion rate\n")
            f.write(f"# propagator: {propagator}   trajectories: "
                    f"{trajectories}\n")
            f.write(f"# broadening: {data['broadening']}   HWHM_G: "
                    f"{data['hwhmG']} eV   HWHM_L: {data['hwhmL']} eV\n")
            f.write(f"# tmin: {data['times'].min() * units.autime_to_fs:.4f} "
                    f"fs  tmax: {data['times'].max() * units.autime_to_fs:.4f}"
                    f" fs  steps= {len(data['times'])}\n")
            f.write("#\n")
            f.write("# Energy/eV                kIC(E)/s^-1\n")
            np.savetxt(f, np.vstack((data["energies"] * units.hartree_to_ev,
                                     data["ic_rate"].real)).T)
    if "spectrum" in data:
        logger.info(f"exporting the spectrum from '{filename}' to "
                    "'spectrum.dat'")
        with open("spectrum.dat", "w") as f:
            f.write("# Franck-Condon spectral density S(E) of the "
                    "wavepacket autocorrelation\n")
            f.write(f"# propagator: {propagator}   trajectories: "
                    f"{trajectories}\n")
            f.write(f"# broadening: {data['spectrum_broadening']}   HWHM_G: "
                    f"{data['spectrum_hwhmG']} eV   HWHM_L: "
                    f"{data['spectrum_hwhmL']} eV\n")
            f.write("# energies are relative to the initial-state "
                    "zero-point energy\n")
            f.write("#\n")
            f.write("# Energy/eV                S(E)/(1/Hartree)\n")
            np.savetxt(f, np.vstack(
                (data["spectrum_energies"] * units.hartree_to_ev,
                 data["spectrum"].real)).T)


def _plot_correlation_functions(filenames, save=""):
    """Render C(t), k~ic(t) and k_IC(E) for one or more results files.

    Capability parity with the reference's plot command (cli.py:630-706);
    the figure layout and rate readout are this framework's own: the rate at
    the adiabatic gap is marked with an annotated point instead of guide
    lines, and each file's propagator/trajectory count rides in its legend
    entry rather than a figure title. With `save` the figure goes to a file
    (forcing the Agg backend so it works without a display) instead of an
    interactive window.
    """
    from semiclassical_jax import units

    if save:
        import matplotlib
        matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    fig, (ax_auto, ax_ic, ax_rate) = plt.subplots(
        1, 3, figsize=(13.0, 5.0))

    for filename in filenames:
        data = np.load(filename)
        t_fs = data["times"] * units.autime_to_fs
        tag = (f"{filename} [{data['propagator']}, "
               f"{int(data['trajectories'])} traj]")

        for ax, key in ((ax_auto, "autocorrelation"),
                        (ax_ic, "ic_correlation")):
            curve = data[key]
            line, = ax.plot(t_fs, curve.real, label=f"Re {tag}")
            ax.plot(t_fs, curve.imag, ls="--", alpha=0.6,
                    color=line.get_color(), label=f"Im {tag}")
            # Monte-Carlo error band (error_bars task keyword): the stderr
            # of the complex mean, drawn around the real part
            if key + "_stderr" in data:
                err = data[key + "_stderr"]
                ax.fill_between(t_fs, curve.real - err, curve.real + err,
                                color=line.get_color(), alpha=0.2, lw=0)

        if "ic_rate" in data:
            en_ev = data["energies"] * units.hartree_to_ev
            line, = ax_rate.plot(en_ev, data["ic_rate"], label=tag)
            # the propagated MC band is one scalar for the whole curve
            # (fourier_stderr); on the log axis a 0 lower edge would render
            # down to the axis floor and swamp the tails, so mask the band
            # wherever the curve falls below the stderr
            if "ic_rate_stderr" in data:
                err = float(data["ic_rate_stderr"])
                lower = data["ic_rate"] - err
                lower = np.where(lower > 0.0, lower, np.nan)
                ax_rate.fill_between(
                    en_ev, lower, data["ic_rate"] + err,
                    color=line.get_color(), alpha=0.2, lw=0)
            gap = float(data["adiabatic_gap"])
            if np.isfinite(gap):
                idx = int(np.argmin(np.abs(data["energies"] - gap)))
                kic = data["ic_rate"][idx]
                ax_rate.plot([gap * units.hartree_to_ev], [kic], "o",
                             color=line.get_color())
                ax_rate.annotate(
                    f"{kic:.2e}" r" s$^{-1}$",
                    (gap * units.hartree_to_ev, kic),
                    textcoords="offset points", xytext=(6, 6),
                    fontsize=9, color=line.get_color())

    ax_auto.set_title("autocorrelation")
    ax_auto.set_xlabel("time / fs")
    ax_auto.set_ylabel(r"$e^{i E_0^{(es)} t / \hbar}"
                       r"\,\langle\phi(0)|\phi(t)\rangle$")
    ax_ic.set_title("IC correlation")
    ax_ic.set_xlabel("time / fs")
    ax_ic.set_ylabel(r"$\tilde{k}_{IC}(t)$")
    ax_ic.legend(fontsize=8)
    ax_rate.set_title("IC rate (dot: at adiabatic gap)")
    ax_rate.set_xlabel("energy gap / eV")
    ax_rate.set_ylabel(r"$k_{IC}(E)$ / s$^{-1}$")
    ax_rate.set_yscale("log")
    ax_rate.set_xlim(0.0, 10.0)
    if ax_rate.get_legend_handles_labels()[0]:
        ax_rate.legend(fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=150)
        print(f"figure written to {save}")
    else:
        plt.show()


def _show_information(filename):
    """Print a summary of a results file (reference cli.py:708-742)."""
    from semiclassical_jax import units

    data = np.load(filename)
    print(f"""
    filename                 : {filename}
    propagator               : {data['propagator']}
    trajectories             : {int(data['trajectories']):10}
    time step (fs)           : {(data['times'][1] - data['times'][0]) * units.autime_to_fs:10.4f}
    propagation time (fs)    : {max(data['times']) * units.autime_to_fs:10.4f}
    zero-point energy (cm-1) : {float(data['zero_point_energy']) * units.hartree_to_wavenumbers:10.4f}
    """)
    if "ic_rate" in data:
        if not np.isnan(data["adiabatic_gap"]):
            iclosest = np.argmin(abs(data["energies"] - data["adiabatic_gap"]))
            kic = data["ic_rate"][iclosest]
        else:
            kic = np.nan
        print(f"""
    adiabatic gap Ead (eV)   : {float(data['adiabatic_gap']) * units.hartree_to_ev:6.3f}
    IC rate kic(Ead) (s-1)   : {kic:6.3e}
        """)
        imax = np.argmax(data["ic_rate"])
        print(f"""
    position of maximum (eV) : {data['energies'][imax] * units.hartree_to_ev:6.3f}
    maximum of IC rate (s-1) : {data['ic_rate'][imax]:6.3e}
        """)
        if "ic_rate_stderr" in data:
            print(f"    rate MC stderr (s-1)     : "
                  f"{float(data['ic_rate_stderr']):6.3e}")
        print("IC rates are only reliable around the maximum of the curve.")
    else:
        print("  No rates found in file, you have to compute them first "
              "with the command 'semi rates'.")
    if "spectrum" in data:
        en = data["spectrum_energies"]
        sp = data["spectrum"]
        imax = np.argmax(sp)
        total = float(np.trapezoid(sp, en))
        print(f"""
    spectrum maximum (eV, rel. ZPE) : {en[imax] * units.hartree_to_ev:6.3f}
    spectrum integral (~1)          : {total:8.5f}
        """)
        if "spectrum_stderr" in data:
            print(f"    spectrum MC stderr (1/Ha)       : "
                  f"{float(data['spectrum_stderr']):6.3e}")


if __name__ == "__main__":
    sys.exit(main())
