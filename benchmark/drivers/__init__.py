"""The general drivers that a traffic mix names under ``"driver"``: ``fit``
(one full-batch fit, a closed loop of steps), ``encode`` (one codec encode
of a window population) and ``decode`` (a stream of decode requests from
one caller).  A mix is data; a driver reads it.  Each driver names the
program's entry it calls (``door``, a name in ``benchmark.port``) and the
kind of its readings (``readings_kind``: ``train``, ``population`` or
``decode``), by which the calibration and the tests find its cases."""
