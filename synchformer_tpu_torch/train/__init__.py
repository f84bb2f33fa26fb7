"""Stage I training: schedules and AdamW (state.py), the AVCLIP train and
eval steps (step.py), the trainer entry point (stage_clip.py)."""
