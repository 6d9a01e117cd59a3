"""The benchmark of frei_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell, a configuration or a metric needs is a file found by its name:

- ``configs/<config>.json``: the deployment (grid, planet or planet
  draws, opacity, chemistry, dtype, ``reduced``, ``assumed``).  The
  opacity block is of one of two kinds: ``"example"`` (``species``,
  ``seed``, ``scale_factor``: frei's one-species fixture, the same at
  every temperature and pressure) or ``"seeded_tp"`` (a list of
  ``species``, ``seed``, and log-spaced ``temps_K`` and ``press_bar``
  axes as ``{"min", "max", "n"}``: seeded T- and P-dependent tables,
  ``reference/inputs.seeded_tp_opacity``);
- ``traffic/<traffic>.json``: ``entry`` (a file of ``entries/``),
  ``engine``, ``columns``, ``iterations``, ``profile_scale`` (the
  initial profiles are T(P) times U(lo, hi) a column), ``pool`` (input
  batches drawn in set-up and cycled), ``warmup_calls``, ``check_calls``
  (calls kept for the check), ``check_block`` (the reference's columns
  at a time), ``trace_calls`` (calls profiled in a ``--trace 1`` run),
  and for gradients ``grad_check_columns`` and ``grad_check_block``;
- ``limits/<cell>.json``: each compared number's limit, with the lower
  (program) and upper (control) readings it was set from;
- ``entries/<entry>.py``: ``prepare``, ``call``, ``reference``, ``gaps``;
- ``metrics/<metric>.py``: ``read(run)``, a number or None;
- ``reference/``: the plain reference, the frozen inputs and counts;
- ``tools/calibrate.py``: the readings a cell's limits are set from;
- ``tools/faults.py``: the faults a broken timed path is tested with;
- ``tools/seeded_tp.py``: the four-species deployment on the card
  before a cell runs it (the program's walls, memory and loop kernel,
  its gaps against the reference, the control's).
"""
