"""What later program changes cannot move: inputs, weights, arithmetic,
peaks, the trace's reduction and kernel classes."""
