"""Backbone building blocks and the seqrec models."""
