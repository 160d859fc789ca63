"""Serving engine of the port and its copy of the plan cache."""
