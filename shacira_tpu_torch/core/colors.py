"""Named color constants for debug layers and visualizers.

The port's copy of ``shacira_tpu/core/colors.py``: the palette of named RGB
constants and ``color_wheel`` for cycling through distinct colors when
painting several data layers.
"""

white = (1.0, 1.0, 1.0)
black = (0.0, 0.0, 0.0)
dark_gray = (0.25, 0.25, 0.25)
gray = (0.5, 0.5, 0.5)
red = (1.0, 0.0, 0.0)
green = (0.0, 1.0, 0.0)
blue = (0.0, 0.0, 1.0)
orange = (1.0, 0.5, 0.0)
gold = (1.0, 0.804, 0.0)
purple = (0.667, 0.0, 0.429)
lime = (0.746, 1.0, 0.0)
lime_green = (0.519, 0.819, 0.0)
light_purple = (0.788, 0.580, 1.0)
light_cyan = (0.796, 1.0, 1.0)
light_pink = (1.0, 0.796, 1.0)
light_yellow = (1.0, 1.0, 0.796)
light_teal = (0.757, 1.0, 0.949)
soft_blue = (0.721, 0.90, 1.0)
soft_red = (1.0, 0.0, 0.085)


def color_wheel():
    """All named colors, ordered for visually distinct cycling."""
    return [red, green, blue, orange, gold, purple, lime, light_purple,
            light_cyan, light_pink, light_yellow, light_teal, soft_blue,
            soft_red, lime_green, white, gray, dark_gray, black]
