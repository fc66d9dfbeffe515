"""The benchmark of `deep_spectral_tpu_torch`, the PyTorch/CUDA port.

`python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of the root `BENCHMARK.json` on the card it is started on and
prints one JSON line. Everything a cell needs is found by name:

  * `configs/<config>.json`: a model configuration (the file `BENCHMARK.json`
    names);
  * `traffic/<traffic>.json`: a traffic mix, whose `driver` key names the kind;
  * `drivers/<driver>.py`: how a kind of cell drives the port (`extract`,
    `eigs`, `train`);
  * `metrics/<metric>.py`: the reader of one per-layer metric;
  * `limits/<workload>.json`: the limits of the numbers that decide `correct`.

`reference/` is the plain PyTorch reference (it imports nothing of the port),
`work.py` the flop and byte counts and the peaks, `trace.py` the reading of
the profiler's device timeline, `features.py` the seeded inputs.
Nothing here imports `jax` or `deep_spectral_tpu`.
"""
