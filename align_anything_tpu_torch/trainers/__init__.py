"""Trainers: the train-step core, the optimizer, and the text-to-text DPO
step (the harness around them is not ported yet, ROADMAP)."""
