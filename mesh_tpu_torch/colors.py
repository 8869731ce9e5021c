"""Color-name lookup (counterpart of mesh_tpu/colors.py; reference
mesh/colors.py).

``name_to_rgb[name]`` -> np.array([r, g, b]) in [0, 1].  The table is
literal data: matplotlib's CSS4 color list (the modern standard covering
the X11 names), expanded with the X11 conventions the reference dict also
carries: spaced forms ('steel blue'), CamelCase forms ('SteelBlue'), and the
gray0..gray100 / grey0..grey100 numeric shades, each component rounded to
two decimals.  It needs no matplotlib at import, which the card's host
does not have.
"""

import re

import numpy as np

_TABLE = {
    'aliceblue': (0.94, 0.97, 1.0), 'alice blue': (0.94, 0.97, 1.0),
    'AliceBlue': (0.94, 0.97, 1.0), 'antiquewhite': (0.98, 0.92, 0.84),
    'antique white': (0.98, 0.92, 0.84), 'AntiqueWhite': (0.98, 0.92, 0.84),
    'aqua': (0.0, 1.0, 1.0), 'Aqua': (0.0, 1.0, 1.0),
    'aquamarine': (0.5, 1.0, 0.83), 'Aquamarine': (0.5, 1.0, 0.83),
    'azure': (0.94, 1.0, 1.0), 'Azure': (0.94, 1.0, 1.0),
    'beige': (0.96, 0.96, 0.86), 'Beige': (0.96, 0.96, 0.86),
    'bisque': (1.0, 0.89, 0.77), 'Bisque': (1.0, 0.89, 0.77),
    'black': (0.0, 0.0, 0.0), 'Black': (0.0, 0.0, 0.0),
    'blanchedalmond': (1.0, 0.92, 0.8), 'blanched almond': (1.0, 0.92, 0.8),
    'BlanchedAlmond': (1.0, 0.92, 0.8), 'blue': (0.0, 0.0, 1.0),
    'Blue': (0.0, 0.0, 1.0), 'blueviolet': (0.54, 0.17, 0.89),
    'blue violet': (0.54, 0.17, 0.89), 'BlueViolet': (0.54, 0.17, 0.89),
    'brown': (0.65, 0.16, 0.16), 'Brown': (0.65, 0.16, 0.16),
    'burlywood': (0.87, 0.72, 0.53), 'Burlywood': (0.87, 0.72, 0.53),
    'cadetblue': (0.37, 0.62, 0.63), 'cadet blue': (0.37, 0.62, 0.63),
    'CadetBlue': (0.37, 0.62, 0.63), 'chartreuse': (0.5, 1.0, 0.0),
    'Chartreuse': (0.5, 1.0, 0.0), 'chocolate': (0.82, 0.41, 0.12),
    'Chocolate': (0.82, 0.41, 0.12), 'coral': (1.0, 0.5, 0.31),
    'Coral': (1.0, 0.5, 0.31), 'cornflowerblue': (0.39, 0.58, 0.93),
    'cornflower blue': (0.39, 0.58, 0.93),
    'CornflowerBlue': (0.39, 0.58, 0.93), 'cornsilk': (1.0, 0.97, 0.86),
    'Cornsilk': (1.0, 0.97, 0.86), 'crimson': (0.86, 0.08, 0.24),
    'Crimson': (0.86, 0.08, 0.24), 'cyan': (0.0, 1.0, 1.0),
    'Cyan': (0.0, 1.0, 1.0), 'darkblue': (0.0, 0.0, 0.55),
    'dark blue': (0.0, 0.0, 0.55), 'DarkBlue': (0.0, 0.0, 0.55),
    'darkcyan': (0.0, 0.55, 0.55), 'dark cyan': (0.0, 0.55, 0.55),
    'DarkCyan': (0.0, 0.55, 0.55), 'darkgoldenrod': (0.72, 0.53, 0.04),
    'dark goldenrod': (0.72, 0.53, 0.04), 'DarkGoldenrod': (0.72, 0.53, 0.04),
    'darkgray': (0.66, 0.66, 0.66), 'dark gray': (0.66, 0.66, 0.66),
    'DarkGray': (0.66, 0.66, 0.66), 'darkgreen': (0.0, 0.39, 0.0),
    'dark green': (0.0, 0.39, 0.0), 'DarkGreen': (0.0, 0.39, 0.0),
    'darkgrey': (0.66, 0.66, 0.66), 'dark grey': (0.66, 0.66, 0.66),
    'DarkGrey': (0.66, 0.66, 0.66), 'darkkhaki': (0.74, 0.72, 0.42),
    'dark khaki': (0.74, 0.72, 0.42), 'DarkKhaki': (0.74, 0.72, 0.42),
    'darkmagenta': (0.55, 0.0, 0.55), 'dark magenta': (0.55, 0.0, 0.55),
    'DarkMagenta': (0.55, 0.0, 0.55), 'darkolivegreen': (0.33, 0.42, 0.18),
    'dark olive green': (0.33, 0.42, 0.18),
    'DarkOliveGreen': (0.33, 0.42, 0.18), 'darkorange': (1.0, 0.55, 0.0),
    'dark orange': (1.0, 0.55, 0.0), 'DarkOrange': (1.0, 0.55, 0.0),
    'darkorchid': (0.6, 0.2, 0.8), 'dark orchid': (0.6, 0.2, 0.8),
    'DarkOrchid': (0.6, 0.2, 0.8), 'darkred': (0.55, 0.0, 0.0),
    'dark red': (0.55, 0.0, 0.0), 'DarkRed': (0.55, 0.0, 0.0),
    'darksalmon': (0.91, 0.59, 0.48), 'dark salmon': (0.91, 0.59, 0.48),
    'DarkSalmon': (0.91, 0.59, 0.48), 'darkseagreen': (0.56, 0.74, 0.56),
    'dark sea green': (0.56, 0.74, 0.56), 'DarkSeaGreen': (0.56, 0.74, 0.56),
    'darkslateblue': (0.28, 0.24, 0.55), 'dark slate blue': (0.28, 0.24, 0.55),
    'DarkSlateBlue': (0.28, 0.24, 0.55), 'darkslategray': (0.18, 0.31, 0.31),
    'dark slate gray': (0.18, 0.31, 0.31), 'DarkSlateGray': (0.18, 0.31, 0.31),
    'darkslategrey': (0.18, 0.31, 0.31), 'dark slate grey': (0.18, 0.31, 0.31),
    'DarkSlateGrey': (0.18, 0.31, 0.31), 'darkturquoise': (0.0, 0.81, 0.82),
    'dark turquoise': (0.0, 0.81, 0.82), 'DarkTurquoise': (0.0, 0.81, 0.82),
    'darkviolet': (0.58, 0.0, 0.83), 'dark violet': (0.58, 0.0, 0.83),
    'DarkViolet': (0.58, 0.0, 0.83), 'deeppink': (1.0, 0.08, 0.58),
    'deep pink': (1.0, 0.08, 0.58), 'DeepPink': (1.0, 0.08, 0.58),
    'deepskyblue': (0.0, 0.75, 1.0), 'deep sky blue': (0.0, 0.75, 1.0),
    'DeepSkyBlue': (0.0, 0.75, 1.0), 'dimgray': (0.41, 0.41, 0.41),
    'dim gray': (0.41, 0.41, 0.41), 'DimGray': (0.41, 0.41, 0.41),
    'dimgrey': (0.41, 0.41, 0.41), 'dim grey': (0.41, 0.41, 0.41),
    'DimGrey': (0.41, 0.41, 0.41), 'dodgerblue': (0.12, 0.56, 1.0),
    'dodger blue': (0.12, 0.56, 1.0), 'DodgerBlue': (0.12, 0.56, 1.0),
    'firebrick': (0.7, 0.13, 0.13), 'Firebrick': (0.7, 0.13, 0.13),
    'floralwhite': (1.0, 0.98, 0.94), 'floral white': (1.0, 0.98, 0.94),
    'FloralWhite': (1.0, 0.98, 0.94), 'forestgreen': (0.13, 0.55, 0.13),
    'forest green': (0.13, 0.55, 0.13), 'ForestGreen': (0.13, 0.55, 0.13),
    'fuchsia': (1.0, 0.0, 1.0), 'Fuchsia': (1.0, 0.0, 1.0),
    'gainsboro': (0.86, 0.86, 0.86), 'Gainsboro': (0.86, 0.86, 0.86),
    'ghostwhite': (0.97, 0.97, 1.0), 'ghost white': (0.97, 0.97, 1.0),
    'GhostWhite': (0.97, 0.97, 1.0), 'gold': (1.0, 0.84, 0.0),
    'Gold': (1.0, 0.84, 0.0), 'goldenrod': (0.85, 0.65, 0.13),
    'Goldenrod': (0.85, 0.65, 0.13), 'gray': (0.5, 0.5, 0.5),
    'Gray': (0.5, 0.5, 0.5), 'green': (0.0, 0.5, 0.0),
    'Green': (0.0, 0.5, 0.0), 'greenyellow': (0.68, 1.0, 0.18),
    'green yellow': (0.68, 1.0, 0.18), 'GreenYellow': (0.68, 1.0, 0.18),
    'grey': (0.5, 0.5, 0.5), 'Grey': (0.5, 0.5, 0.5),
    'honeydew': (0.94, 1.0, 0.94), 'Honeydew': (0.94, 1.0, 0.94),
    'hotpink': (1.0, 0.41, 0.71), 'hot pink': (1.0, 0.41, 0.71),
    'HotPink': (1.0, 0.41, 0.71), 'indianred': (0.8, 0.36, 0.36),
    'indian red': (0.8, 0.36, 0.36), 'IndianRed': (0.8, 0.36, 0.36),
    'indigo': (0.29, 0.0, 0.51), 'Indigo': (0.29, 0.0, 0.51),
    'ivory': (1.0, 1.0, 0.94), 'Ivory': (1.0, 1.0, 0.94),
    'khaki': (0.94, 0.9, 0.55), 'Khaki': (0.94, 0.9, 0.55),
    'lavender': (0.9, 0.9, 0.98), 'Lavender': (0.9, 0.9, 0.98),
    'lavenderblush': (1.0, 0.94, 0.96), 'Lavenderblush': (1.0, 0.94, 0.96),
    'lawngreen': (0.49, 0.99, 0.0), 'lawn green': (0.49, 0.99, 0.0),
    'LawnGreen': (0.49, 0.99, 0.0), 'lemonchiffon': (1.0, 0.98, 0.8),
    'lemon chiffon': (1.0, 0.98, 0.8), 'LemonChiffon': (1.0, 0.98, 0.8),
    'lightblue': (0.68, 0.85, 0.9), 'light blue': (0.68, 0.85, 0.9),
    'LightBlue': (0.68, 0.85, 0.9), 'lightcoral': (0.94, 0.5, 0.5),
    'light coral': (0.94, 0.5, 0.5), 'LightCoral': (0.94, 0.5, 0.5),
    'lightcyan': (0.88, 1.0, 1.0), 'light cyan': (0.88, 1.0, 1.0),
    'LightCyan': (0.88, 1.0, 1.0), 'lightgoldenrodyellow': (0.98, 0.98, 0.82),
    'light goldenrod yellow': (0.98, 0.98, 0.82),
    'LightGoldenrodYellow': (0.98, 0.98, 0.82),
    'lightgray': (0.83, 0.83, 0.83), 'light gray': (0.83, 0.83, 0.83),
    'LightGray': (0.83, 0.83, 0.83), 'lightgreen': (0.56, 0.93, 0.56),
    'light green': (0.56, 0.93, 0.56), 'LightGreen': (0.56, 0.93, 0.56),
    'lightgrey': (0.83, 0.83, 0.83), 'light grey': (0.83, 0.83, 0.83),
    'LightGrey': (0.83, 0.83, 0.83), 'lightpink': (1.0, 0.71, 0.76),
    'light pink': (1.0, 0.71, 0.76), 'LightPink': (1.0, 0.71, 0.76),
    'lightsalmon': (1.0, 0.63, 0.48), 'light salmon': (1.0, 0.63, 0.48),
    'LightSalmon': (1.0, 0.63, 0.48), 'lightseagreen': (0.13, 0.7, 0.67),
    'light sea green': (0.13, 0.7, 0.67), 'LightSeaGreen': (0.13, 0.7, 0.67),
    'lightskyblue': (0.53, 0.81, 0.98), 'light sky blue': (0.53, 0.81, 0.98),
    'LightSkyBlue': (0.53, 0.81, 0.98), 'lightslategray': (0.47, 0.53, 0.6),
    'light slate gray': (0.47, 0.53, 0.6), 'LightSlateGray': (0.47, 0.53, 0.6),
    'lightslategrey': (0.47, 0.53, 0.6), 'light slate grey': (0.47, 0.53, 0.6),
    'LightSlateGrey': (0.47, 0.53, 0.6), 'lightsteelblue': (0.69, 0.77, 0.87),
    'light steel blue': (0.69, 0.77, 0.87),
    'LightSteelBlue': (0.69, 0.77, 0.87), 'lightyellow': (1.0, 1.0, 0.88),
    'light yellow': (1.0, 1.0, 0.88), 'LightYellow': (1.0, 1.0, 0.88),
    'lime': (0.0, 1.0, 0.0), 'Lime': (0.0, 1.0, 0.0),
    'limegreen': (0.2, 0.8, 0.2), 'lime green': (0.2, 0.8, 0.2),
    'LimeGreen': (0.2, 0.8, 0.2), 'linen': (0.98, 0.94, 0.9),
    'Linen': (0.98, 0.94, 0.9), 'magenta': (1.0, 0.0, 1.0),
    'Magenta': (1.0, 0.0, 1.0), 'maroon': (0.5, 0.0, 0.0),
    'Maroon': (0.5, 0.0, 0.0), 'mediumaquamarine': (0.4, 0.8, 0.67),
    'medium aquamarine': (0.4, 0.8, 0.67),
    'MediumAquamarine': (0.4, 0.8, 0.67), 'mediumblue': (0.0, 0.0, 0.8),
    'medium blue': (0.0, 0.0, 0.8), 'MediumBlue': (0.0, 0.0, 0.8),
    'mediumorchid': (0.73, 0.33, 0.83), 'medium orchid': (0.73, 0.33, 0.83),
    'MediumOrchid': (0.73, 0.33, 0.83), 'mediumpurple': (0.58, 0.44, 0.86),
    'medium purple': (0.58, 0.44, 0.86), 'MediumPurple': (0.58, 0.44, 0.86),
    'mediumseagreen': (0.24, 0.7, 0.44), 'medium sea green': (0.24, 0.7, 0.44),
    'MediumSeaGreen': (0.24, 0.7, 0.44), 'mediumslateblue': (0.48, 0.41, 0.93),
    'medium slate blue': (0.48, 0.41, 0.93),
    'MediumSlateBlue': (0.48, 0.41, 0.93),
    'mediumspringgreen': (0.0, 0.98, 0.6),
    'medium spring green': (0.0, 0.98, 0.6),
    'MediumSpringGreen': (0.0, 0.98, 0.6),
    'mediumturquoise': (0.28, 0.82, 0.8),
    'medium turquoise': (0.28, 0.82, 0.8),
    'MediumTurquoise': (0.28, 0.82, 0.8),
    'mediumvioletred': (0.78, 0.08, 0.52),
    'medium violet red': (0.78, 0.08, 0.52),
    'MediumVioletRed': (0.78, 0.08, 0.52), 'midnightblue': (0.1, 0.1, 0.44),
    'midnight blue': (0.1, 0.1, 0.44), 'MidnightBlue': (0.1, 0.1, 0.44),
    'mintcream': (0.96, 1.0, 0.98), 'mint cream': (0.96, 1.0, 0.98),
    'MintCream': (0.96, 1.0, 0.98), 'mistyrose': (1.0, 0.89, 0.88),
    'misty rose': (1.0, 0.89, 0.88), 'MistyRose': (1.0, 0.89, 0.88),
    'moccasin': (1.0, 0.89, 0.71), 'Moccasin': (1.0, 0.89, 0.71),
    'navajowhite': (1.0, 0.87, 0.68), 'navajo white': (1.0, 0.87, 0.68),
    'NavajoWhite': (1.0, 0.87, 0.68), 'navy': (0.0, 0.0, 0.5),
    'Navy': (0.0, 0.0, 0.5), 'oldlace': (0.99, 0.96, 0.9),
    'old lace': (0.99, 0.96, 0.9), 'OldLace': (0.99, 0.96, 0.9),
    'olive': (0.5, 0.5, 0.0), 'Olive': (0.5, 0.5, 0.0),
    'olivedrab': (0.42, 0.56, 0.14), 'olive drab': (0.42, 0.56, 0.14),
    'OliveDrab': (0.42, 0.56, 0.14), 'orange': (1.0, 0.65, 0.0),
    'Orange': (1.0, 0.65, 0.0), 'orangered': (1.0, 0.27, 0.0),
    'orange red': (1.0, 0.27, 0.0), 'OrangeRed': (1.0, 0.27, 0.0),
    'orchid': (0.85, 0.44, 0.84), 'Orchid': (0.85, 0.44, 0.84),
    'palegoldenrod': (0.93, 0.91, 0.67), 'pale goldenrod': (0.93, 0.91, 0.67),
    'PaleGoldenrod': (0.93, 0.91, 0.67), 'palegreen': (0.6, 0.98, 0.6),
    'pale green': (0.6, 0.98, 0.6), 'PaleGreen': (0.6, 0.98, 0.6),
    'paleturquoise': (0.69, 0.93, 0.93), 'pale turquoise': (0.69, 0.93, 0.93),
    'PaleTurquoise': (0.69, 0.93, 0.93), 'palevioletred': (0.86, 0.44, 0.58),
    'pale violet red': (0.86, 0.44, 0.58), 'PaleVioletRed': (0.86, 0.44, 0.58),
    'papayawhip': (1.0, 0.94, 0.84), 'papaya whip': (1.0, 0.94, 0.84),
    'PapayaWhip': (1.0, 0.94, 0.84), 'peachpuff': (1.0, 0.85, 0.73),
    'peach puff': (1.0, 0.85, 0.73), 'PeachPuff': (1.0, 0.85, 0.73),
    'peru': (0.8, 0.52, 0.25), 'Peru': (0.8, 0.52, 0.25),
    'pink': (1.0, 0.75, 0.8), 'Pink': (1.0, 0.75, 0.8),
    'plum': (0.87, 0.63, 0.87), 'Plum': (0.87, 0.63, 0.87),
    'powderblue': (0.69, 0.88, 0.9), 'powder blue': (0.69, 0.88, 0.9),
    'PowderBlue': (0.69, 0.88, 0.9), 'purple': (0.5, 0.0, 0.5),
    'Purple': (0.5, 0.0, 0.5), 'rebeccapurple': (0.4, 0.2, 0.6),
    'rebecca purple': (0.4, 0.2, 0.6), 'RebeccaPurple': (0.4, 0.2, 0.6),
    'red': (1.0, 0.0, 0.0), 'Red': (1.0, 0.0, 0.0),
    'rosybrown': (0.74, 0.56, 0.56), 'rosy brown': (0.74, 0.56, 0.56),
    'RosyBrown': (0.74, 0.56, 0.56), 'royalblue': (0.25, 0.41, 0.88),
    'royal blue': (0.25, 0.41, 0.88), 'RoyalBlue': (0.25, 0.41, 0.88),
    'saddlebrown': (0.55, 0.27, 0.07), 'saddle brown': (0.55, 0.27, 0.07),
    'SaddleBrown': (0.55, 0.27, 0.07), 'salmon': (0.98, 0.5, 0.45),
    'Salmon': (0.98, 0.5, 0.45), 'sandybrown': (0.96, 0.64, 0.38),
    'sandy brown': (0.96, 0.64, 0.38), 'SandyBrown': (0.96, 0.64, 0.38),
    'seagreen': (0.18, 0.55, 0.34), 'sea green': (0.18, 0.55, 0.34),
    'SeaGreen': (0.18, 0.55, 0.34), 'seashell': (1.0, 0.96, 0.93),
    'Seashell': (1.0, 0.96, 0.93), 'sienna': (0.63, 0.32, 0.18),
    'Sienna': (0.63, 0.32, 0.18), 'silver': (0.75, 0.75, 0.75),
    'Silver': (0.75, 0.75, 0.75), 'skyblue': (0.53, 0.81, 0.92),
    'sky blue': (0.53, 0.81, 0.92), 'SkyBlue': (0.53, 0.81, 0.92),
    'slateblue': (0.42, 0.35, 0.8), 'slate blue': (0.42, 0.35, 0.8),
    'SlateBlue': (0.42, 0.35, 0.8), 'slategray': (0.44, 0.5, 0.56),
    'slate gray': (0.44, 0.5, 0.56), 'SlateGray': (0.44, 0.5, 0.56),
    'slategrey': (0.44, 0.5, 0.56), 'slate grey': (0.44, 0.5, 0.56),
    'SlateGrey': (0.44, 0.5, 0.56), 'snow': (1.0, 0.98, 0.98),
    'Snow': (1.0, 0.98, 0.98), 'springgreen': (0.0, 1.0, 0.5),
    'spring green': (0.0, 1.0, 0.5), 'SpringGreen': (0.0, 1.0, 0.5),
    'steelblue': (0.27, 0.51, 0.71), 'steel blue': (0.27, 0.51, 0.71),
    'SteelBlue': (0.27, 0.51, 0.71), 'tan': (0.82, 0.71, 0.55),
    'Tan': (0.82, 0.71, 0.55), 'teal': (0.0, 0.5, 0.5),
    'Teal': (0.0, 0.5, 0.5), 'thistle': (0.85, 0.75, 0.85),
    'Thistle': (0.85, 0.75, 0.85), 'tomato': (1.0, 0.39, 0.28),
    'Tomato': (1.0, 0.39, 0.28), 'turquoise': (0.25, 0.88, 0.82),
    'Turquoise': (0.25, 0.88, 0.82), 'violet': (0.93, 0.51, 0.93),
    'Violet': (0.93, 0.51, 0.93), 'wheat': (0.96, 0.87, 0.7),
    'Wheat': (0.96, 0.87, 0.7), 'white': (1.0, 1.0, 1.0),
    'White': (1.0, 1.0, 1.0), 'whitesmoke': (0.96, 0.96, 0.96),
    'white smoke': (0.96, 0.96, 0.96), 'WhiteSmoke': (0.96, 0.96, 0.96),
    'yellow': (1.0, 1.0, 0.0), 'Yellow': (1.0, 1.0, 0.0),
    'yellowgreen': (0.6, 0.8, 0.2), 'yellow green': (0.6, 0.8, 0.2),
    'YellowGreen': (0.6, 0.8, 0.2), 'gray0': (0.0, 0.0, 0.0),
    'grey0': (0.0, 0.0, 0.0), 'gray1': (0.01, 0.01, 0.01),
    'grey1': (0.01, 0.01, 0.01), 'gray2': (0.02, 0.02, 0.02),
    'grey2': (0.02, 0.02, 0.02), 'gray3': (0.03, 0.03, 0.03),
    'grey3': (0.03, 0.03, 0.03), 'gray4': (0.04, 0.04, 0.04),
    'grey4': (0.04, 0.04, 0.04), 'gray5': (0.05, 0.05, 0.05),
    'grey5': (0.05, 0.05, 0.05), 'gray6': (0.06, 0.06, 0.06),
    'grey6': (0.06, 0.06, 0.06), 'gray7': (0.07, 0.07, 0.07),
    'grey7': (0.07, 0.07, 0.07), 'gray8': (0.08, 0.08, 0.08),
    'grey8': (0.08, 0.08, 0.08), 'gray9': (0.09, 0.09, 0.09),
    'grey9': (0.09, 0.09, 0.09), 'gray10': (0.1, 0.1, 0.1),
    'grey10': (0.1, 0.1, 0.1), 'gray11': (0.11, 0.11, 0.11),
    'grey11': (0.11, 0.11, 0.11), 'gray12': (0.12, 0.12, 0.12),
    'grey12': (0.12, 0.12, 0.12), 'gray13': (0.13, 0.13, 0.13),
    'grey13': (0.13, 0.13, 0.13), 'gray14': (0.14, 0.14, 0.14),
    'grey14': (0.14, 0.14, 0.14), 'gray15': (0.15, 0.15, 0.15),
    'grey15': (0.15, 0.15, 0.15), 'gray16': (0.16, 0.16, 0.16),
    'grey16': (0.16, 0.16, 0.16), 'gray17': (0.17, 0.17, 0.17),
    'grey17': (0.17, 0.17, 0.17), 'gray18': (0.18, 0.18, 0.18),
    'grey18': (0.18, 0.18, 0.18), 'gray19': (0.19, 0.19, 0.19),
    'grey19': (0.19, 0.19, 0.19), 'gray20': (0.2, 0.2, 0.2),
    'grey20': (0.2, 0.2, 0.2), 'gray21': (0.21, 0.21, 0.21),
    'grey21': (0.21, 0.21, 0.21), 'gray22': (0.22, 0.22, 0.22),
    'grey22': (0.22, 0.22, 0.22), 'gray23': (0.23, 0.23, 0.23),
    'grey23': (0.23, 0.23, 0.23), 'gray24': (0.24, 0.24, 0.24),
    'grey24': (0.24, 0.24, 0.24), 'gray25': (0.25, 0.25, 0.25),
    'grey25': (0.25, 0.25, 0.25), 'gray26': (0.26, 0.26, 0.26),
    'grey26': (0.26, 0.26, 0.26), 'gray27': (0.27, 0.27, 0.27),
    'grey27': (0.27, 0.27, 0.27), 'gray28': (0.28, 0.28, 0.28),
    'grey28': (0.28, 0.28, 0.28), 'gray29': (0.29, 0.29, 0.29),
    'grey29': (0.29, 0.29, 0.29), 'gray30': (0.3, 0.3, 0.3),
    'grey30': (0.3, 0.3, 0.3), 'gray31': (0.31, 0.31, 0.31),
    'grey31': (0.31, 0.31, 0.31), 'gray32': (0.32, 0.32, 0.32),
    'grey32': (0.32, 0.32, 0.32), 'gray33': (0.33, 0.33, 0.33),
    'grey33': (0.33, 0.33, 0.33), 'gray34': (0.34, 0.34, 0.34),
    'grey34': (0.34, 0.34, 0.34), 'gray35': (0.35, 0.35, 0.35),
    'grey35': (0.35, 0.35, 0.35), 'gray36': (0.36, 0.36, 0.36),
    'grey36': (0.36, 0.36, 0.36), 'gray37': (0.37, 0.37, 0.37),
    'grey37': (0.37, 0.37, 0.37), 'gray38': (0.38, 0.38, 0.38),
    'grey38': (0.38, 0.38, 0.38), 'gray39': (0.39, 0.39, 0.39),
    'grey39': (0.39, 0.39, 0.39), 'gray40': (0.4, 0.4, 0.4),
    'grey40': (0.4, 0.4, 0.4), 'gray41': (0.41, 0.41, 0.41),
    'grey41': (0.41, 0.41, 0.41), 'gray42': (0.42, 0.42, 0.42),
    'grey42': (0.42, 0.42, 0.42), 'gray43': (0.43, 0.43, 0.43),
    'grey43': (0.43, 0.43, 0.43), 'gray44': (0.44, 0.44, 0.44),
    'grey44': (0.44, 0.44, 0.44), 'gray45': (0.45, 0.45, 0.45),
    'grey45': (0.45, 0.45, 0.45), 'gray46': (0.46, 0.46, 0.46),
    'grey46': (0.46, 0.46, 0.46), 'gray47': (0.47, 0.47, 0.47),
    'grey47': (0.47, 0.47, 0.47), 'gray48': (0.48, 0.48, 0.48),
    'grey48': (0.48, 0.48, 0.48), 'gray49': (0.49, 0.49, 0.49),
    'grey49': (0.49, 0.49, 0.49), 'gray50': (0.5, 0.5, 0.5),
    'grey50': (0.5, 0.5, 0.5), 'gray51': (0.51, 0.51, 0.51),
    'grey51': (0.51, 0.51, 0.51), 'gray52': (0.52, 0.52, 0.52),
    'grey52': (0.52, 0.52, 0.52), 'gray53': (0.53, 0.53, 0.53),
    'grey53': (0.53, 0.53, 0.53), 'gray54': (0.54, 0.54, 0.54),
    'grey54': (0.54, 0.54, 0.54), 'gray55': (0.55, 0.55, 0.55),
    'grey55': (0.55, 0.55, 0.55), 'gray56': (0.56, 0.56, 0.56),
    'grey56': (0.56, 0.56, 0.56), 'gray57': (0.57, 0.57, 0.57),
    'grey57': (0.57, 0.57, 0.57), 'gray58': (0.58, 0.58, 0.58),
    'grey58': (0.58, 0.58, 0.58), 'gray59': (0.59, 0.59, 0.59),
    'grey59': (0.59, 0.59, 0.59), 'gray60': (0.6, 0.6, 0.6),
    'grey60': (0.6, 0.6, 0.6), 'gray61': (0.61, 0.61, 0.61),
    'grey61': (0.61, 0.61, 0.61), 'gray62': (0.62, 0.62, 0.62),
    'grey62': (0.62, 0.62, 0.62), 'gray63': (0.63, 0.63, 0.63),
    'grey63': (0.63, 0.63, 0.63), 'gray64': (0.64, 0.64, 0.64),
    'grey64': (0.64, 0.64, 0.64), 'gray65': (0.65, 0.65, 0.65),
    'grey65': (0.65, 0.65, 0.65), 'gray66': (0.66, 0.66, 0.66),
    'grey66': (0.66, 0.66, 0.66), 'gray67': (0.67, 0.67, 0.67),
    'grey67': (0.67, 0.67, 0.67), 'gray68': (0.68, 0.68, 0.68),
    'grey68': (0.68, 0.68, 0.68), 'gray69': (0.69, 0.69, 0.69),
    'grey69': (0.69, 0.69, 0.69), 'gray70': (0.7, 0.7, 0.7),
    'grey70': (0.7, 0.7, 0.7), 'gray71': (0.71, 0.71, 0.71),
    'grey71': (0.71, 0.71, 0.71), 'gray72': (0.72, 0.72, 0.72),
    'grey72': (0.72, 0.72, 0.72), 'gray73': (0.73, 0.73, 0.73),
    'grey73': (0.73, 0.73, 0.73), 'gray74': (0.74, 0.74, 0.74),
    'grey74': (0.74, 0.74, 0.74), 'gray75': (0.75, 0.75, 0.75),
    'grey75': (0.75, 0.75, 0.75), 'gray76': (0.76, 0.76, 0.76),
    'grey76': (0.76, 0.76, 0.76), 'gray77': (0.77, 0.77, 0.77),
    'grey77': (0.77, 0.77, 0.77), 'gray78': (0.78, 0.78, 0.78),
    'grey78': (0.78, 0.78, 0.78), 'gray79': (0.79, 0.79, 0.79),
    'grey79': (0.79, 0.79, 0.79), 'gray80': (0.8, 0.8, 0.8),
    'grey80': (0.8, 0.8, 0.8), 'gray81': (0.81, 0.81, 0.81),
    'grey81': (0.81, 0.81, 0.81), 'gray82': (0.82, 0.82, 0.82),
    'grey82': (0.82, 0.82, 0.82), 'gray83': (0.83, 0.83, 0.83),
    'grey83': (0.83, 0.83, 0.83), 'gray84': (0.84, 0.84, 0.84),
    'grey84': (0.84, 0.84, 0.84), 'gray85': (0.85, 0.85, 0.85),
    'grey85': (0.85, 0.85, 0.85), 'gray86': (0.86, 0.86, 0.86),
    'grey86': (0.86, 0.86, 0.86), 'gray87': (0.87, 0.87, 0.87),
    'grey87': (0.87, 0.87, 0.87), 'gray88': (0.88, 0.88, 0.88),
    'grey88': (0.88, 0.88, 0.88), 'gray89': (0.89, 0.89, 0.89),
    'grey89': (0.89, 0.89, 0.89), 'gray90': (0.9, 0.9, 0.9),
    'grey90': (0.9, 0.9, 0.9), 'gray91': (0.91, 0.91, 0.91),
    'grey91': (0.91, 0.91, 0.91), 'gray92': (0.92, 0.92, 0.92),
    'grey92': (0.92, 0.92, 0.92), 'gray93': (0.93, 0.93, 0.93),
    'grey93': (0.93, 0.93, 0.93), 'gray94': (0.94, 0.94, 0.94),
    'grey94': (0.94, 0.94, 0.94), 'gray95': (0.95, 0.95, 0.95),
    'grey95': (0.95, 0.95, 0.95), 'gray96': (0.96, 0.96, 0.96),
    'grey96': (0.96, 0.96, 0.96), 'gray97': (0.97, 0.97, 0.97),
    'grey97': (0.97, 0.97, 0.97), 'gray98': (0.98, 0.98, 0.98),
    'grey98': (0.98, 0.98, 0.98), 'gray99': (0.99, 0.99, 0.99),
    'grey99': (0.99, 0.99, 0.99), 'gray100': (1.0, 1.0, 1.0),
    'grey100': (1.0, 1.0, 1.0),
}

name_to_rgb = {name: np.array(rgb) for name, rgb in _TABLE.items()}
del _TABLE


def jet(val):
    """Map a scalar in [0, 1] through the jet colormap -> (1, 3) row
    (shared by Mesh.colors_like and Lines.colors_like; reference inlines the
    same arithmetic in both, mesh.py:141-152 / lines.py:35-44)."""
    four = 4 * float(val)
    rgb = np.array([
        min(four - 1.5, -four + 4.5),
        min(four - 0.5, -four + 3.5),
        min(four + 0.5, -four + 2.5),
    ])
    return np.clip(rgb, 0.0, 1.0).reshape(1, 3)


#: matplotlib's jet colormap as segment data (x, y0, y1) per channel
_JET_DATA = (
    ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
     (0.910, 0, 0), (1.000, 0, 0)),
    ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
     (1.00, 0, 0)),
)
#: entries of the lookup table (matplotlib's ``image.lut`` default)
_JET_N = 256


def _segment_lut(data, n):
    """matplotlib's ``_create_lookup_table(n, data)`` for gamma 1."""
    adata = np.array(data, dtype=np.float64)
    x = adata[:, 0] * (n - 1)
    y0, y1 = adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([
        [y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def cm_jet(values):
    """RGBA rows of matplotlib's ``cm.jet(values)`` for float values
    (its 256-entry lookup table, rebuilt without matplotlib): a value in
    [0, 1] picks entry ``int(value * 256)`` (1.0 the last), below 0 the
    first entry, above 1 the last, NaN transparent black."""
    lut = np.ones((_JET_N + 3, 4))
    for channel, data in enumerate(_JET_DATA):
        lut[:_JET_N, channel] = _segment_lut(data, _JET_N)
    lut[_JET_N] = lut[0]                  # under
    lut[_JET_N + 1] = lut[_JET_N - 1]     # over
    lut[_JET_N + 2] = 0.0                 # bad
    xa = np.array(values, dtype=np.float64) * _JET_N
    xa[xa == _JET_N] = _JET_N - 1
    under, over, bad = xa < 0, xa >= _JET_N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = _JET_N
    idx[over] = _JET_N + 1
    idx[bad] = _JET_N + 2
    return lut.take(idx, axis=0, mode="clip")


def expand_colors(color, n_rows):
    """Expand `color` into an (n_rows, 3) float rgb array.

    Accepts a color name, an rgb triple, an (N, 3) per-row array, or N
    scalar weights (each mapped through the jet colormap).  Shared backend
    of Mesh.colors_like / Lines.colors_like (reference mesh.py:129-145,
    lines.py:28-48).
    """
    rgb = (
        name_to_rgb[color]
        if isinstance(color, str)
        else np.asarray(color, dtype=np.float64)
    )
    if rgb.ndim >= 1 and rgb.shape[0] == rgb.size == n_rows:
        rgb = np.vstack([jet(w) for w in rgb.ravel()])
    return np.broadcast_to(rgb, (n_rows, 3)).astype(np.float64).copy()


def main():
    """Generate static dict code from an X11-format rgb.txt, as the
    reference's generator does (colors.py:17-31)."""
    with open("rgb.txt") as fp:
        for line in fp:
            reg = re.match(r"\s*(\d+)\s*(\d+)\s*(\d+)\s*(\w.*\w).*", line)
            if reg:
                r, g, b = (int(reg.group(i)) / 255.0 for i in (1, 2, 3))
                print("'%s': np.array([%.2f, %.2f, %.2f])," % (reg.group(4), r, g, b))
