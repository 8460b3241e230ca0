"""The benchmark's harness: cell lookup by name, what the traffic drivers
share, spans and the device trace, the comparisons that decide
``correct``, and the result line."""
