"""Array ops: encode, lookup, chaining DP, POA DP and traceback."""
