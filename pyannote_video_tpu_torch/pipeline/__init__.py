"""Pipeline stages built on the ops and models."""
