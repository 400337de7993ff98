"""Federated-learning plane: aggregators, controller, executors, simulator, job system."""
