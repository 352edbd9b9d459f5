"""Command-line entry points: `render_eval` (render a prediction folder
from a checkpoint and score it) and `eval_folder` (score a folder)."""
