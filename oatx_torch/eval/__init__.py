"""Evaluation (port of oatx/eval)."""
