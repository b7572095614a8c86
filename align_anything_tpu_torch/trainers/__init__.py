"""Trainers: the trainer base (configs, data, checkpoints, the loop), the
CLI, the optimizer, and the text-to-text trainers (SFT, DPO, ORPO, SimPO,
RM, cost model, rm_score, PPO, multi-PPO)."""
