"""Trainers: the trainer base (configs, data, checkpoints, the loop), the
CLI, the optimizer, and the text-to-text SFT, DPO, ORPO and SimPO
trainers."""
