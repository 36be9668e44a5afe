"""One module a kind of traffic: fit, observe, render."""
