"""Training: schedules and optimizers (state.py), the Stage I and Stage II/III
train and eval steps (step.py), the trainers with their fit loops
(stage_clip.py, stage_sync.py), the classification metrics (metrics.py) and the syncability
evaluation (syncability_eval.py)."""
