"""LM training: learning-rate schedules, optimizers and the train step."""
