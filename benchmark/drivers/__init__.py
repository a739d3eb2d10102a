"""The general drivers that a traffic mix names under ``"driver"``: ``fit``
(one full-batch fit, a closed loop of steps), ``encode`` (one codec encode
of a window population) and ``decode`` (a stream of decode requests from
one caller).  A mix is data; a driver reads it.  A new driver is a new
file here, found by its name; nothing else names it.

A driver's ``Driver(cell)`` has:

- ``door``: the program's entry it calls, a name that ``port.door``
  resolves; it calls ``port.door(self.door)(...)`` at every call;
- ``setup()``, ``window(seconds, tracing)``, ``metrics(run, wall_s)`` and
  ``readings()``: a run, as ``harness.run_cell`` drives it;
- ``fault(kind)``: the door with the timed path broken, for each kind of
  ``FAULTS``, which the tests plant in ``port.DOORS``;
- ``cases()``: the readings its limits are set from (``calibrate``), after
  ``setup()`` and, where ``cases_after_window`` is true, a window.
"""

FAULTS = ("unchanged", "half_batch", "altered")
