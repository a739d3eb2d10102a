"""The general drivers that a traffic mix names under ``"driver"``: ``fit``
(one full-batch fit, a closed loop of steps) and ``decode`` (a stream of
decode requests from one caller).  A mix is data; a driver reads it."""
