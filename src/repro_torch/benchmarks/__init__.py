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
- :mod:`.bench_risk`, :mod:`.bench_chaos`, :mod:`.bench_region` — the
  risk, chaos and region subsystems' sweeps (``main(argv)``, ``--smoke``,
  ``--json PATH``);
- :mod:`.run` — the runner: ``python -m repro_torch.benchmarks.run
  [--only NAME] [--json PATH]``.

Each prints what the reference's driver prints.  Every solve runs on the
process-default backend (``KUBEPACS_SOLVER_BACKEND``, the card's
``torch`` unless set: ``torch:cpu``, ``torch:fused:cpu`` or ``numpy`` on
a host), handed explicitly to the calls that take a ``backend``.
"""
