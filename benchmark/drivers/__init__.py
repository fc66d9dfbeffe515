"""Drivers: how each kind of cell drives the port. A traffic mix names its
driver (`"driver": "<kind>"`); `harness.driver` loads `drivers/<kind>.py`,
whose `Runner(cell, seed, device)` makes the inputs and warms up (set-up),
and then runs `window(seconds)` or `traced(seconds)`, `release()` and
`check()`."""
