"""Serving: prefill and decode steps and the continuous-batching session."""
