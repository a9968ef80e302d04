"""Kinds of step, one file each, found by the name a traffic file gives
under ``kind`` (``cell.kind_module``; ``mpc`` where it gives none).

A kind's module supplies what the harness (``harness.py``, ``session.py``)
and the control (``control.py``) need to know of a step:

* ``Program(config_path, device, dtype)``: the measured program, with
  ``device``, ``sizes`` (a dict the metric readers read), ``libraries``,
  ``build()``, ``episode_start()`` (a carry), ``step(carry, eps)`` ->
  ``(carry, out)`` with ``out.ok`` false where the step failed, and
  ``launch_counts()``;
* ``control(config_path, device)``: the control of the correctness
  check, a system like ``Program`` that the check must refuse;
* ``Draws(mix, sizes, seed, device, dtype)``: the draws made at set-up
  from the seed; ``episode(e)`` gives episode e's, one entry a step;
* ``record(loop, carry, eps, out)``: what a kept step holds for the
  check, made as the loop (``harness.Loop``) keeps it;
* ``counts(out)``: the step's whole numbers that metric readers read
  (``session.Context.window`` and ``traced``);
* ``compare(cell, records, device, seed)``: the check's readings,
  ``{"compared": n, <number>: worst, ...}``, of which the cell's limits
  file names those that decide ``correct``;
* ``FAULTS``: fault name -> ``plant(system)``, which breaks the system's
  timed path and returns the undo (``faults.planted``);
* ``MIX_KEYS`` (optional): further whole-number keys of its traffic
  files (``traffic.Mix.extra``).
"""
