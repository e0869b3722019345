"""Launch-side entry points: the train and serve steps and the training
CLI (``python -m repro_torch.launch.train``). The reference's dry-run
lowering, HLO analysis and roofline modules are not ported yet (ROADMAP
§1)."""
