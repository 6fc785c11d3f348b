"""The general runners of traffic, one per kind."""
