"""Bulk evaluation: prediction folders and their scores."""
