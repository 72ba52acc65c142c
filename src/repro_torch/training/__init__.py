"""Training on one device — the port of ``repro.training``: AdamW with the
reference's schedule (``optimizer``), its synthetic token stream
(``data``), ``.npz`` checkpoints (``checkpoint``) and the training step
and loop (``train_loop``) over ``models.model.loss_fn``."""
