"""Built-in minimal world navdata: the standalone fallback database
(a copy of the JAX package's ``navdb/builtin_data.py``).

The reference ships an 11 MB third-party navdata compilation
(``data/navdata/`` — fix.dat/nav.dat/airports.dat etc.) that this repo
does not redistribute.  Without it the navdb used to
start empty; this module instead provides a compact, SELF-AUTHORED
fallback so a standalone install can fly between real-world places out
of the box: ~190 major international airports and a small set of
well-known European enroute VORs.

Accuracy: written from general geographic knowledge.  Airport
reference points are good to roughly +-0.05 deg (a few km); VOR
positions can be off by more (tens of km for some) and elevations/
runway lengths are ballpark — adequate for simulation scenarios and
demos, NOT for operational/chart use or real-procedure fidelity.
Runway thresholds are deliberately not
bundled (a threshold wrong by 500 m is worse than none); `DEFRWY`
defines them at runtime, or point `settings.navdata_path` at a real
navdata directory (reference format) to replace all of this.

Schema matches `loaders.load_navdata` output, so `Navdatabase.reset`
consumes either source identically.
"""

# ICAO: (lat, lon, elev_m, maxrwy_m, country, name)
AIRPORTS = {
    # ---- Europe ----
    "EHAM": (52.31, 4.76, -3, 3800, "NL", "Amsterdam Schiphol"),
    "EHRD": (51.96, 4.44, -4, 2200, "NL", "Rotterdam The Hague"),
    "EHEH": (51.45, 5.37, 22, 3000, "NL", "Eindhoven"),
    "EHGG": (53.12, 6.58, 5, 2700, "NL", "Groningen Eelde"),
    "EBBR": (50.90, 4.48, 56, 3600, "BE", "Brussels"),
    "EBLG": (50.64, 5.44, 200, 3700, "BE", "Liege"),
    "ELLX": (49.63, 6.20, 376, 4000, "LU", "Luxembourg"),
    "EGLL": (51.47, -0.46, 25, 3900, "GB", "London Heathrow"),
    "EGKK": (51.15, -0.19, 62, 3300, "GB", "London Gatwick"),
    "EGSS": (51.88, 0.24, 106, 3000, "GB", "London Stansted"),
    "EGGW": (51.87, -0.37, 160, 2200, "GB", "London Luton"),
    "EGLC": (51.51, 0.06, 5, 1500, "GB", "London City"),
    "EGCC": (53.35, -2.27, 78, 3000, "GB", "Manchester"),
    "EGBB": (52.45, -1.75, 100, 2600, "GB", "Birmingham"),
    "EGPH": (55.95, -3.37, 41, 2600, "GB", "Edinburgh"),
    "EGPF": (55.87, -4.43, 8, 2700, "GB", "Glasgow"),
    "EGNT": (55.04, -1.69, 81, 2300, "GB", "Newcastle"),
    "EIDW": (53.42, -6.27, 74, 3100, "IE", "Dublin"),
    "EICK": (51.84, -8.49, 153, 2100, "IE", "Cork"),
    "LFPG": (49.01, 2.55, 119, 4200, "FR", "Paris Charles de Gaulle"),
    "LFPO": (48.73, 2.38, 89, 3650, "FR", "Paris Orly"),
    "LFBO": (43.63, 1.37, 152, 3500, "FR", "Toulouse Blagnac"),
    "LFML": (43.44, 5.22, 21, 3500, "FR", "Marseille Provence"),
    "LFLL": (45.73, 5.08, 250, 4000, "FR", "Lyon Saint-Exupery"),
    "LFMN": (43.66, 7.22, 4, 2960, "FR", "Nice Cote d'Azur"),
    "LFSB": (47.60, 7.53, 270, 3900, "FR", "Basel-Mulhouse"),
    "LFRS": (47.16, -1.61, 27, 2900, "FR", "Nantes Atlantique"),
    "EDDF": (50.03, 8.57, 111, 4000, "DE", "Frankfurt Main"),
    "EDDM": (48.35, 11.79, 448, 4000, "DE", "Munich"),
    "EDDB": (52.37, 13.50, 48, 4000, "DE", "Berlin Brandenburg"),
    "EDDH": (53.63, 10.00, 16, 3660, "DE", "Hamburg"),
    "EDDL": (51.29, 6.77, 45, 3000, "DE", "Dusseldorf"),
    "EDDK": (50.87, 7.14, 92, 3800, "DE", "Cologne Bonn"),
    "EDDS": (48.69, 9.22, 389, 3350, "DE", "Stuttgart"),
    "EDDV": (52.46, 9.69, 55, 3800, "DE", "Hannover"),
    "EDDN": (49.50, 11.08, 318, 2700, "DE", "Nuremberg"),
    "LEMD": (40.47, -3.56, 610, 4100, "ES", "Madrid Barajas"),
    "LEBL": (41.30, 2.08, 4, 3350, "ES", "Barcelona El Prat"),
    "LEPA": (39.55, 2.74, 8, 3270, "ES", "Palma de Mallorca"),
    "LEMG": (36.67, -4.50, 16, 3200, "ES", "Malaga"),
    "LEAL": (38.28, -0.56, 43, 3000, "ES", "Alicante"),
    "LEZL": (37.42, -5.90, 34, 3360, "ES", "Seville"),
    "LPPT": (38.77, -9.13, 114, 3800, "PT", "Lisbon"),
    "LPPR": (41.24, -8.68, 69, 3480, "PT", "Porto"),
    "LPFR": (37.01, -7.97, 7, 2490, "PT", "Faro"),
    "LIRF": (41.80, 12.25, 5, 3900, "IT", "Rome Fiumicino"),
    "LIMC": (45.63, 8.72, 234, 3920, "IT", "Milan Malpensa"),
    "LIML": (45.45, 9.28, 108, 2440, "IT", "Milan Linate"),
    "LIPZ": (45.51, 12.35, 2, 3300, "IT", "Venice Marco Polo"),
    "LIRN": (40.88, 14.29, 90, 2650, "IT", "Naples"),
    "LICC": (37.47, 15.07, 12, 2400, "IT", "Catania"),
    "LSZH": (47.46, 8.55, 432, 3700, "CH", "Zurich"),
    "LSGG": (46.24, 6.11, 430, 3900, "CH", "Geneva"),
    "LOWW": (48.11, 16.57, 183, 3600, "AT", "Vienna Schwechat"),
    "LKPR": (50.10, 14.26, 380, 3700, "CZ", "Prague Vaclav Havel"),
    "EPWA": (52.17, 20.97, 110, 3690, "PL", "Warsaw Chopin"),
    "EPKK": (50.08, 19.80, 241, 2550, "PL", "Krakow"),
    "LHBP": (47.44, 19.26, 151, 3700, "HU", "Budapest"),
    "LROP": (44.57, 26.09, 96, 3500, "RO", "Bucharest Otopeni"),
    "LBSF": (42.70, 23.41, 531, 3600, "BG", "Sofia"),
    "LGAV": (37.94, 23.94, 94, 4000, "GR", "Athens"),
    "LGTS": (40.52, 22.97, 7, 2440, "GR", "Thessaloniki"),
    "LCLK": (34.88, 33.62, 2, 3000, "CY", "Larnaca"),
    "LMML": (35.86, 14.48, 91, 3540, "MT", "Malta Luqa"),
    "LTFM": (41.26, 28.74, 99, 4100, "TR", "Istanbul"),
    "LTFJ": (40.90, 29.31, 30, 3000, "TR", "Istanbul Sabiha Gokcen"),
    "LTAI": (36.90, 30.79, 54, 3400, "TR", "Antalya"),
    "LTAC": (40.13, 32.99, 953, 3750, "TR", "Ankara Esenboga"),
    "UUEE": (55.97, 37.41, 190, 3700, "RU", "Moscow Sheremetyevo"),
    "UUDD": (55.41, 37.91, 171, 3800, "RU", "Moscow Domodedovo"),
    "ULLI": (59.80, 30.26, 24, 3780, "RU", "St Petersburg Pulkovo"),
    "UKBB": (50.35, 30.89, 130, 4000, "UA", "Kyiv Boryspil"),
    "EKCH": (55.62, 12.65, 5, 3600, "DK", "Copenhagen Kastrup"),
    "ENGM": (60.19, 11.10, 208, 3600, "NO", "Oslo Gardermoen"),
    "ENBR": (60.29, 5.22, 50, 2990, "NO", "Bergen Flesland"),
    "ESSA": (59.65, 17.92, 42, 3300, "SE", "Stockholm Arlanda"),
    "ESGG": (57.66, 12.28, 152, 3300, "SE", "Gothenburg Landvetter"),
    "EFHK": (60.32, 24.96, 55, 3500, "FI", "Helsinki Vantaa"),
    "EVRA": (56.92, 23.97, 11, 3200, "LV", "Riga"),
    "EYVI": (54.63, 25.29, 197, 2515, "LT", "Vilnius"),
    "EETN": (59.41, 24.83, 40, 3070, "EE", "Tallinn"),
    "LDZA": (45.74, 16.07, 108, 3250, "HR", "Zagreb"),
    "LDSP": (43.54, 16.30, 24, 2550, "HR", "Split"),
    "LJLJ": (46.22, 14.46, 388, 3300, "SI", "Ljubljana"),
    "LYBE": (44.82, 20.31, 102, 3400, "RS", "Belgrade"),
    "LQSA": (43.82, 18.33, 518, 2600, "BA", "Sarajevo"),
    "LWSK": (41.96, 21.62, 238, 2450, "MK", "Skopje"),
    "BIKF": (63.99, -22.61, 52, 3050, "IS", "Keflavik"),
    # ---- North America ----
    "KJFK": (40.64, -73.78, 4, 4400, "US", "New York JFK"),
    "KLGA": (40.78, -73.87, 6, 2100, "US", "New York LaGuardia"),
    "KEWR": (40.69, -74.17, 5, 3300, "US", "Newark Liberty"),
    "KBOS": (42.36, -71.01, 6, 3050, "US", "Boston Logan"),
    "KPHL": (39.87, -75.24, 11, 3200, "US", "Philadelphia"),
    "KIAD": (38.95, -77.46, 95, 3500, "US", "Washington Dulles"),
    "KDCA": (38.85, -77.04, 5, 2100, "US", "Washington National"),
    "KBWI": (39.18, -76.67, 45, 3200, "US", "Baltimore-Washington"),
    "KATL": (33.64, -84.43, 313, 3600, "US", "Atlanta Hartsfield"),
    "KMIA": (25.79, -80.29, 3, 3960, "US", "Miami"),
    "KFLL": (26.07, -80.15, 3, 2740, "US", "Fort Lauderdale"),
    "KMCO": (28.43, -81.31, 29, 3660, "US", "Orlando"),
    "KTPA": (27.98, -82.53, 8, 3350, "US", "Tampa"),
    "KCLT": (35.21, -80.94, 228, 3050, "US", "Charlotte Douglas"),
    "KORD": (41.98, -87.90, 204, 3960, "US", "Chicago O'Hare"),
    "KMDW": (41.79, -87.75, 188, 2000, "US", "Chicago Midway"),
    "KDTW": (42.21, -83.35, 196, 3660, "US", "Detroit Metro"),
    "KMSP": (44.88, -93.22, 256, 3350, "US", "Minneapolis-St Paul"),
    "KSTL": (38.75, -90.37, 187, 3350, "US", "St Louis Lambert"),
    "KMCI": (39.30, -94.71, 313, 3290, "US", "Kansas City"),
    "KDEN": (39.86, -104.67, 1655, 4880, "US", "Denver"),
    "KSLC": (40.79, -111.98, 1288, 3660, "US", "Salt Lake City"),
    "KPHX": (33.43, -112.01, 345, 3500, "US", "Phoenix Sky Harbor"),
    "KLAS": (36.08, -115.15, 665, 4420, "US", "Las Vegas"),
    "KLAX": (33.94, -118.41, 38, 3680, "US", "Los Angeles"),
    "KSFO": (37.62, -122.38, 4, 3600, "US", "San Francisco"),
    "KSJC": (37.36, -121.93, 19, 3350, "US", "San Jose"),
    "KOAK": (37.72, -122.22, 3, 3050, "US", "Oakland"),
    "KSAN": (32.73, -117.19, 5, 2865, "US", "San Diego"),
    "KSEA": (47.45, -122.31, 132, 3630, "US", "Seattle-Tacoma"),
    "KPDX": (45.59, -122.60, 9, 3350, "US", "Portland"),
    "KIAH": (29.98, -95.34, 30, 3660, "US", "Houston Bush"),
    "KDFW": (32.90, -97.04, 185, 4080, "US", "Dallas-Fort Worth"),
    "KAUS": (30.19, -97.67, 165, 3660, "US", "Austin-Bergstrom"),
    "KMSY": (29.99, -90.26, 1, 3080, "US", "New Orleans"),
    "KPIT": (40.49, -80.23, 367, 3500, "US", "Pittsburgh"),
    "KCLE": (41.41, -81.85, 241, 3000, "US", "Cleveland Hopkins"),
    "KCVG": (39.05, -84.66, 273, 3660, "US", "Cincinnati"),
    "KMEM": (35.04, -89.98, 104, 3390, "US", "Memphis"),
    "KBNA": (36.12, -86.68, 183, 3360, "US", "Nashville"),
    "PHNL": (21.32, -157.92, 4, 3750, "US", "Honolulu"),
    "PANC": (61.17, -149.98, 46, 3320, "US", "Anchorage"),
    "CYYZ": (43.68, -79.63, 173, 3390, "CA", "Toronto Pearson"),
    "CYVR": (49.19, -123.18, 4, 3500, "CA", "Vancouver"),
    "CYUL": (45.47, -73.74, 36, 3350, "CA", "Montreal Trudeau"),
    "CYYC": (51.11, -114.02, 1084, 4270, "CA", "Calgary"),
    "CYOW": (45.32, -75.67, 114, 3050, "CA", "Ottawa"),
    "MMMX": (19.44, -99.07, 2230, 3960, "MX", "Mexico City"),
    "MMUN": (21.04, -86.87, 6, 3500, "MX", "Cancun"),
    "MMGL": (20.52, -103.31, 1528, 4000, "MX", "Guadalajara"),
    # ---- South America ----
    "SBGR": (-23.43, -46.47, 750, 3700, "BR", "Sao Paulo Guarulhos"),
    "SBSP": (-23.63, -46.66, 802, 1940, "BR", "Sao Paulo Congonhas"),
    "SBGL": (-22.81, -43.25, 9, 4000, "BR", "Rio de Janeiro Galeao"),
    "SBBR": (-15.87, -47.92, 1066, 3300, "BR", "Brasilia"),
    "SAEZ": (-34.82, -58.54, 20, 3300, "AR", "Buenos Aires Ezeiza"),
    "SABE": (-34.56, -58.42, 6, 2100, "AR", "Buenos Aires Aeroparque"),
    "SCEL": (-33.39, -70.79, 474, 3800, "CL", "Santiago"),
    "SPIM": (-12.02, -77.11, 34, 3500, "PE", "Lima Jorge Chavez"),
    "SKBO": (4.70, -74.15, 2548, 3800, "CO", "Bogota El Dorado"),
    "SVMI": (10.60, -66.99, 72, 3500, "VE", "Caracas Maiquetia"),
    "SEQM": (-0.13, -78.36, 2400, 4100, "EC", "Quito"),
    "SUMU": (-34.84, -56.03, 32, 3200, "UY", "Montevideo Carrasco"),
    "SGAS": (-25.24, -57.52, 101, 3350, "PY", "Asuncion"),
    # ---- Africa & Middle East ----
    "DNMM": (6.58, 3.32, 41, 3900, "NG", "Lagos Murtala Muhammed"),
    "DGAA": (5.61, -0.17, 62, 3400, "GH", "Accra Kotoka"),
    "GMMN": (33.37, -7.59, 200, 3720, "MA", "Casablanca Mohammed V"),
    "DAAG": (36.69, 3.22, 25, 3500, "DZ", "Algiers"),
    "DTTA": (36.85, 10.23, 7, 3200, "TN", "Tunis Carthage"),
    "HECA": (30.12, 31.41, 116, 4000, "EG", "Cairo"),
    "HEGN": (27.18, 33.80, 16, 4000, "EG", "Hurghada"),
    "HAAB": (8.98, 38.80, 2334, 3800, "ET", "Addis Ababa Bole"),
    "HKJK": (-1.32, 36.93, 1624, 4100, "KE", "Nairobi Jomo Kenyatta"),
    "HTDA": (-6.88, 39.20, 55, 3000, "TZ", "Dar es Salaam"),
    "FAOR": (-26.14, 28.25, 1694, 4420, "ZA", "Johannesburg OR Tambo"),
    "FACT": (-33.97, 18.60, 46, 3200, "ZA", "Cape Town"),
    "FALE": (-29.61, 31.12, 92, 3700, "ZA", "Durban King Shaka"),
    "FNLU": (-8.86, 13.23, 74, 3700, "AO", "Luanda"),
    "FIMP": (-20.43, 57.68, 57, 3040, "MU", "Mauritius"),
    "GVAC": (16.74, -22.95, 55, 3270, "CV", "Sal Amilcar Cabral"),
    "OMDB": (25.25, 55.36, 19, 4450, "AE", "Dubai"),
    "OMAA": (24.43, 54.65, 27, 4100, "AE", "Abu Dhabi"),
    "OTHH": (25.27, 51.61, 4, 4850, "QA", "Doha Hamad"),
    "OERK": (24.96, 46.70, 625, 4200, "SA", "Riyadh King Khalid"),
    "OEJN": (21.68, 39.16, 15, 4000, "SA", "Jeddah King Abdulaziz"),
    "OKBK": (29.23, 47.97, 63, 3500, "KW", "Kuwait"),
    "OBBI": (26.27, 50.63, 2, 3960, "BH", "Bahrain"),
    "OOMS": (23.59, 58.28, 15, 4000, "OM", "Muscat"),
    "LLBG": (32.01, 34.89, 41, 3660, "IL", "Tel Aviv Ben Gurion"),
    "OJAI": (31.72, 35.99, 730, 3660, "JO", "Amman Queen Alia"),
    "ORBI": (33.26, 44.23, 34, 4000, "IQ", "Baghdad"),
    "OIIE": (35.42, 51.15, 1007, 4200, "IR", "Tehran Imam Khomeini"),
    # ---- Asia ----
    "VIDP": (28.57, 77.10, 237, 4430, "IN", "Delhi Indira Gandhi"),
    "VABB": (19.09, 72.87, 11, 3660, "IN", "Mumbai"),
    "VOBL": (13.20, 77.71, 915, 4000, "IN", "Bengaluru"),
    "VOMM": (12.99, 80.17, 16, 3660, "IN", "Chennai"),
    "VECC": (22.65, 88.45, 5, 3630, "IN", "Kolkata"),
    "VOHS": (17.24, 78.43, 617, 4260, "IN", "Hyderabad"),
    "VCBI": (7.18, 79.88, 9, 3350, "LK", "Colombo Bandaranaike"),
    "VGHS": (23.84, 90.40, 9, 3200, "BD", "Dhaka"),
    "VNKT": (27.70, 85.36, 1338, 3050, "NP", "Kathmandu"),
    "VTBS": (13.69, 100.75, 2, 4000, "TH", "Bangkok Suvarnabhumi"),
    "VTBD": (13.91, 100.60, 3, 3700, "TH", "Bangkok Don Mueang"),
    "VTSP": (8.11, 98.31, 25, 3000, "TH", "Phuket"),
    "WSSS": (1.36, 103.99, 7, 4000, "SG", "Singapore Changi"),
    "WMKK": (2.75, 101.71, 21, 4100, "MY", "Kuala Lumpur"),
    "WIII": (-6.13, 106.66, 10, 3660, "ID", "Jakarta Soekarno-Hatta"),
    "WADD": (-8.75, 115.17, 4, 3000, "ID", "Bali Ngurah Rai"),
    "RPLL": (14.51, 121.02, 23, 3740, "PH", "Manila Ninoy Aquino"),
    "VHHH": (22.31, 113.91, 9, 3800, "HK", "Hong Kong"),
    "VMMC": (22.15, 113.59, 6, 3360, "MO", "Macau"),
    "ZGGG": (23.39, 113.31, 15, 3800, "CN", "Guangzhou Baiyun"),
    "ZGSZ": (22.64, 113.81, 4, 3400, "CN", "Shenzhen Bao'an"),
    "ZSPD": (31.14, 121.81, 4, 4000, "CN", "Shanghai Pudong"),
    "ZSSS": (31.20, 121.34, 3, 3400, "CN", "Shanghai Hongqiao"),
    "ZBAA": (40.08, 116.58, 35, 3800, "CN", "Beijing Capital"),
    "ZBAD": (39.51, 116.41, 30, 3800, "CN", "Beijing Daxing"),
    "ZUUU": (30.58, 103.95, 495, 3600, "CN", "Chengdu Shuangliu"),
    "ZPPP": (25.10, 102.93, 2103, 4000, "CN", "Kunming Changshui"),
    "ZLXY": (34.44, 108.75, 479, 3800, "CN", "Xi'an Xianyang"),
    "ZHHH": (30.78, 114.21, 34, 3400, "CN", "Wuhan Tianhe"),
    "ZSAM": (24.54, 118.13, 18, 3400, "CN", "Xiamen Gaoqi"),
    "ZSHC": (30.23, 120.43, 7, 3600, "CN", "Hangzhou Xiaoshan"),
    "RJTT": (35.55, 139.78, 6, 3360, "JP", "Tokyo Haneda"),
    "RJAA": (35.76, 140.39, 43, 4000, "JP", "Tokyo Narita"),
    "RJOO": (34.79, 135.44, 12, 3000, "JP", "Osaka Itami"),
    "RJBB": (34.43, 135.23, 5, 4000, "JP", "Osaka Kansai"),
    "RJGG": (34.86, 136.81, 4, 3500, "JP", "Nagoya Chubu"),
    "RJCC": (42.78, 141.69, 25, 3000, "JP", "Sapporo New Chitose"),
    "RJFF": (33.59, 130.45, 9, 2800, "JP", "Fukuoka"),
    "ROAH": (26.20, 127.65, 4, 3000, "JP", "Naha Okinawa"),
    "RKSI": (37.46, 126.44, 7, 4000, "KR", "Seoul Incheon"),
    "RKSS": (37.56, 126.79, 18, 3600, "KR", "Seoul Gimpo"),
    "RKPC": (33.51, 126.49, 36, 3180, "KR", "Jeju"),
    "RCTP": (25.08, 121.23, 33, 3800, "TW", "Taipei Taoyuan"),
    "RCSS": (25.07, 121.55, 5, 3050, "TW", "Taipei Songshan"),
    "UAAA": (43.35, 77.04, 681, 4400, "KZ", "Almaty"),
    "UTTT": (41.26, 69.28, 417, 4000, "UZ", "Tashkent"),
    "OPKC": (24.91, 67.16, 30, 3400, "PK", "Karachi Jinnah"),
    "OPLA": (31.52, 74.40, 217, 3360, "PK", "Lahore"),
    # ---- Oceania ----
    "YSSY": (-33.95, 151.18, 6, 3960, "AU", "Sydney Kingsford Smith"),
    "YMML": (-37.67, 144.84, 132, 3660, "AU", "Melbourne Tullamarine"),
    "YBBN": (-27.38, 153.12, 4, 3560, "AU", "Brisbane"),
    "YPPH": (-31.94, 115.97, 20, 3440, "AU", "Perth"),
    "YPAD": (-34.95, 138.53, 6, 3100, "AU", "Adelaide"),
    "YSCB": (-35.31, 149.19, 575, 3280, "AU", "Canberra"),
    "NZAA": (-37.01, 174.79, 7, 3640, "NZ", "Auckland"),
    "NZWN": (-41.33, 174.81, 12, 2080, "NZ", "Wellington"),
    "NZCH": (-43.49, 172.53, 37, 3290, "NZ", "Christchurch"),
    "NFFN": (-17.76, 177.44, 18, 3270, "FJ", "Nadi"),
}

# name: (lat, lon, type) — a small set of well-known European enroute
# VORs (approximate positions; enough to demo ADDWPT/DIRECT by name)
WAYPOINTS = {
    "SPY": (52.54, 4.85, "VOR"),     # Spijkerboor
    "PAM": (52.33, 5.09, "VOR"),     # Pampus
    "RTM": (51.95, 4.44, "VOR"),     # Rotterdam
    "EHV": (51.45, 5.40, "VOR"),     # Eindhoven
    "HDR": (52.91, 4.76, "VOR"),     # Den Helder
    "NIK": (51.16, 4.19, "VOR"),     # Nicky (Belgium)
    "KOK": (51.09, 2.65, "VOR"),     # Koksy
    "BUB": (50.90, 4.54, "VOR"),     # Brussels
    "FFM": (50.05, 8.63, "VOR"),     # Frankfurt
    "NTM": (50.01, 7.37, "VOR"),     # Nattenheim
    "CLN": (51.85, 1.15, "VOR"),     # Clacton
    "LAM": (51.65, 0.15, "VOR"),     # Lambourne
    "BNN": (51.73, -0.55, "VOR"),    # Bovingdon
    "OCK": (51.30, -0.45, "VOR"),    # Ockham
    "BIG": (51.33, 0.03, "VOR"),     # Biggin
    "CPT": (51.49, -1.22, "VOR"),    # Compton
    "DVR": (51.16, 1.36, "VOR"),     # Dover
    "CGN": (50.87, 7.12, "VOR"),     # Cologne
    "DKB": (49.14, 10.24, "VOR"),    # Dinkelsbuehl
    "TGO": (48.62, 9.26, "VOR"),     # Tango (Stuttgart)
    "TRA": (47.69, 8.44, "VOR"),     # Trasadingen
    "ZUE": (47.59, 8.82, "VOR"),     # Zurich East
    "ABB": (50.14, 1.85, "VOR"),     # Abbeville
}


def load_builtin():
    """The fallback navdata dict, `loaders.load_navdata`-shaped."""
    apts = sorted(AIRPORTS.items())
    wpts = sorted(WAYPOINTS.items())
    return {
        "wpid": [w for w, _ in wpts],
        "wplat": [v[0] for _, v in wpts],
        "wplon": [v[1] for _, v in wpts],
        "wptype": [v[2] for _, v in wpts],
        "aptid": [a for a, _ in apts],
        "aptname": [v[5] for _, v in apts],
        "aptlat": [v[0] for _, v in apts],
        "aptlon": [v[1] for _, v in apts],
        "aptelev": [float(v[2]) for _, v in apts],
        "aptmaxrwy": [float(v[3]) for _, v in apts],
        "aptco": [v[4] for _, v in apts],
    }
