"""Launch-side entry points: the train and serve steps and the reference's
sharding trees (``steps``), the training CLI (``python -m
repro_torch.launch.train``, under ``torchrun`` for a mesh), meshes over
processes (``mesh``: process groups, named axes, the collectives, and
``spawn`` for a world on one host) and the census of one card, the port of
the reference's dry-run: ``steps.prepare_cell`` builds a cell on the card,
``op_cost`` counts a step's FLOPs and bytes, ``roofline`` prices them on
the H100, ``census`` (``python -m repro_torch.launch.census``) sweeps the
(arch × shape) cells and ``census_join`` the verify superstep. The
dry-run's mesh options wait for a later slice (ROADMAP §1)."""
