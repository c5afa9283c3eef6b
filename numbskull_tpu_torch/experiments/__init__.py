"""The experiment drivers of the PyTorch port, one module per driver of
the JAX package's ``experiments/``: ``micro_gather``, ``micro_gather2``,
``micro_gather_xla``, ``degree_sweep``, ``hbm_scale``,
``engine_tradeoff`` and ``profile_itemgrid``. Each runs as
``python -m numbskull_tpu_torch.experiments.<name> [out.tsv] ...`` with
the arguments of its JAX counterpart after the output path, on
``--device cuda`` unless the caller asks for ``cpu``, and writes a TSV
whose first line names the card. Results of full-size runs on the card
are under ``results/``."""
