"""The paper's evaluation on the port, each driver a module that runs as
``python -m repro_torch.benchmarks.<name>`` (``run()`` returns its record,
``main()`` prints its ``name,us_per_call,derived`` line):

- :mod:`.fig5_sota` — KubePACS against Greedy, SpotVerse and Karpenter
  over the paper's 20 scenarios;
- :mod:`.fig5c_spotkube` — against SpotKube's NSGA-II on four small types;
- :mod:`.fig6_alpha` — the E_Total(α) landscape over market snapshots;
- :mod:`.fig6b_cross_provider` — the pipeline on an Azure-like market;
- :mod:`.table2_fixed_alpha` — fixed α ∈ {0, 0.5, 1} against the GSS;
- :mod:`.fig7_tolerance` — the GSS tolerance against solves and E_Total;
- :mod:`.fig8_preferences` — workload intents and specialized types;
- :mod:`.fig9_t3_fulfillment` — fulfillment by T3 bucket;
- :mod:`.fig12_interrupts` — interrupt handling against Karpenter;
- :mod:`.table3_perf_dollar` — performance per dollar on compute-bound
  applications;
- :mod:`.bench_solver` — guarded-GSS cycles, the engine against the seed
  history-matrix solver, with ``tracemalloc`` peaks;
- :mod:`.bench_backend` — a fleet tick's decisions through the first
  NumPy engine, the batched NumPy engine, ``torch`` and ``torch:fused``,
  plus a catalog-size scaling column (``--device cuda|cpu``);
- :mod:`.bench_scale` — one decision from 5 k to 1 M pods through the
  coarsening ladder, verified against the exact engine
  (``--full-exact``, ``--device cuda|cpu``);
- :mod:`.bench_risk`, :mod:`.bench_chaos`, :mod:`.bench_region` — the
  risk, chaos and region subsystems' sweeps;
- :mod:`.bench_fleet` — ``FleetSim`` against per-seed ``run_replicas``
  (storm, crunch) and the batched tick on and off (hetero);
- :mod:`.bench_serve` — served QPS per dollar under SLO, five policies;
- :mod:`.elastic_training` — the smoke internlm2 trained through
  ``ElasticSpotTrainer`` under pressure interrupts;
- :mod:`.roofline_report` — the dry-run records' roofline terms;
- :mod:`.perf_gate` — ratio metrics against ``PERF_REFERENCE_torch.json``
  (``--update`` writes it; not in the runner, as in the reference);
- :mod:`.make_tables` — the dry-run and roofline tables in markdown from
  a ``dryrun_*.jsonl`` (not in the runner);
- :mod:`.run` — the runner: ``python -m repro_torch.benchmarks.run
  [--only NAME] [--json PATH]``.

The benches (``bench_*``) take ``main(argv)`` with ``--smoke`` and
``--json PATH``, and write nothing unless ``--json`` names a path.

Each prints what the reference's driver prints (record keys ``*_jax*``
become ``*_torch*``).  Every solve runs on the
process-default backend (``KUBEPACS_SOLVER_BACKEND``, the card's
``torch`` unless set: ``torch:cpu``, ``torch:fused:cpu`` or ``numpy`` on
a host), handed explicitly to the calls that take a ``backend``.
"""
