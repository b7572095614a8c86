"""Text-to-text trainers (DPO's step so far)."""
