"""Traffic kinds, each a module found by the ``kind`` of a mix's data
file (``traffic/<mix>.json`` -> ``kinds/<kind>.py``).

A kind provides:

* ``make(params, seed, words)``: the traffic, built in set-up from the
  mix's parameters, the seed and the dictionary's base words in rank
  order;
* ``warm(al, traffic)``: every shape the window uses, once; returns
  where the window's traffic starts;
* ``keeper(params, rng)``: what keeps the window's results for the
  check (``offer(item)``, ``items``);
* ``loop(al, traffic, samprate, seconds, spans, keep, start)``: the
  window's closed loop, a ``loops.Record``;
* ``check(ref, traffic, kept, rec, params, rng, control)``: the numbers
  ``check.LIMITS`` names for the program, and with ``control`` (a
  precision of the reference) the same numbers for the control, the
  reference in that precision put in the program's place (else None);
* ``work(ref, traffic, rec, kept)``: the window's work by kernel
  (``counts``), for the rooflines and ``mfu``.

A new kind is a new module; a new mix of a kind is a new data file.
"""
