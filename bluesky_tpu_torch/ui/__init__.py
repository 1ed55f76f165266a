"""UI layer: headless radar rendering + the GUI client data mirror.

Port of ``bluesky_tpu/ui``.  ``palette``, ``polytools`` and ``console``
are host code, copied; ``radar`` and ``radarclick`` read the live
state on the card in one device-to-host copy per picture; ``web``
serves the radar of the port's ``Simulation`` or of a ``GuiClient``
mirror of the port's server.

The reference ships a Qt-OpenGL radar (ui/qtgl/, ~3k LoC of GL state)
and a legacy pygame screen.  This framework is headless-first: the
equivalent surface is (a) the GuiClient-compatible ACDATA/ROUTEDATA
streams (simulation/screenio.py), (b) the client-side nodeData mirror
(network/guiclient.py), and (c) an SVG radar renderer (ui/radar.py)
that draws the same picture the RadarWidget draws — aircraft symbols
with labels, trails, area shapes, the selected route — into a file any
browser displays.  SCREENSHOT renders it sim-side.

Shared frontend logic, usable by any client (reference parity):
- ``radarclick`` — click-to-command-line completion (ui/radarclick.py)
- ``console``    — command-line state/history/IC-autocomplete
  (ui/qtgl/console.py + autocomplete.py, de-Qt-ified)
- ``polytools``  — polygon -> triangle buffers (GLU tessellator replaced
  by pure-NumPy ear clipping)
- ``palette``    — colour registry (exec()-based palette files replaced
  by literal-parsed ones)
"""
