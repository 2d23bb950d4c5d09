"""The fault-tolerant training driver."""
