"""Operator core: dictionary, hashing, filter, signatures, indexes, plan."""
