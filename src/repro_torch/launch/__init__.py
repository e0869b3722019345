"""Launch-side entry points: the train and serve steps, the training CLI
(``python -m repro_torch.launch.train``) and the census of one card, the
port of the reference's dry-run: ``steps.prepare_cell`` builds a cell on
the card, ``op_cost`` counts a step's FLOPs and bytes, ``roofline`` prices
them on the H100, ``census`` (``python -m repro_torch.launch.census``)
sweeps the (arch × shape) cells and ``census_join`` the verify superstep.
The reference's meshes and sharding trees wait for the multi-process
slice (ROADMAP §1)."""
