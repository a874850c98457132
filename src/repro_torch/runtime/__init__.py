"""Executors that run an ExecutionPlan on PyTorch tensors."""
