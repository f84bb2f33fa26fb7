"""Weight conversion and seeded initialisation, checkpoints, experiment
logging and plots."""
